"""Plain version of the ca_pool kernel: ``core.compressive`` is the oracle.

Both modes of the kernel are ``compressive_acquire``'s: the fused weighted
acquisition (an exact float32 FMA chain over c, then di, then dj) and the
per-channel mean (a row-major window sum, then one division).
"""

from __future__ import annotations

from repro_torch.core.compressive import ca_coefficients, compressive_acquire

ca_pool_ref = compressive_acquire

__all__ = ["ca_coefficients", "ca_pool_ref"]
