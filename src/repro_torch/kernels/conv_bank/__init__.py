"""Conv kernels: the fused chain wrapper (fused) and plain versions (ref)."""
