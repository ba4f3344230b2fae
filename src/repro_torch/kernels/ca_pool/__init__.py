"""Compressive Acquisitor kernel: wrapper (ops) and plain version (ref)."""
