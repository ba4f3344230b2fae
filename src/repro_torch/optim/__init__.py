"""Optimizer substrate: AdamW with an f32 master copy, the global-norm clip
and the learning-rate schedules, as functional updates over dicts of
tensors."""
