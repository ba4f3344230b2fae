"""The plan executor's fused epilogue: wrapper (ops) and plain version (ref)."""
