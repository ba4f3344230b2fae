"""Examples of the port, run as modules (``python -m
repro_torch.examples.<name>``): ``quickstart``, ``imaging_demo`` and
``train_lm_100m``."""
