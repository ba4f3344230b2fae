"""repro_torch — the Lightator reproduction on PyTorch and CUDA (Hopper).

A port of the ``repro`` package, beside it. Same layer IR, plans, power
reports and numerics (bit for bit); every TPU kernel on a ported path is a
hand-written CUDA kernel for ``sm_90a`` (``csrc/``), built with ``nvcc`` on
first use.

  core/      quantization, layer IR, compressive acquisition, the power
             model, the plan compiler/executor and the Program API
  kernels/   dispatch plus each kernel's wrapper and plain version:
             photonic_mvm, conv_bank (the fused chain), ca_pool
  models/    the paper's CNNs
  serve/     the micro-batching serving runtime, one device
  weights    params across the two packages (numpy)

Entry points run on ``cuda`` unless the caller asks for the CPU.
"""

__all__ = ["Program", "Options", "Executable"]


def __getattr__(name):
    if name in __all__:
        from repro_torch.core import program
        return getattr(program, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
