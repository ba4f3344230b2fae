"""Conv kernels: the strip kernels' wrappers (strip), the public conv_bank
op (ops), the fused chain wrapper (fused) and plain versions (ref)."""
