"""Photonic MVM kernel: wrapper (ops) and plain version (ref)."""
