"""repro_torch imaging pipelines against the stored golden arrays.

``tests/golden/<pipeline>.npz`` pins the reference package's complete
output on a textured batch (32x32x3, W4A4, per-tensor ``run``). The port,
with numpy and torch alone, must reproduce both the float path
(``apply_float``) and the quantized device path (through the kernel
wrappers' CPU path) within the golden test's own 1e-5.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from repro_torch import Options, Program
from repro_torch.core.quant import W4A4
from repro_torch.imaging import PIPELINES, apply_float

GOLDEN_DIR = Path(__file__).resolve().parent / "golden"


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_port_matches_golden(name):
    data = np.load(GOLDEN_DIR / f"{name}.npz")
    assert str(data["scheme"]) == "w4a4"
    frames, hw = data["frames"], int(data["hw"])
    prog = Program.from_pipeline(name, hw, hw, frames.shape[-1])
    np.testing.assert_allclose(
        apply_float(prog.layers, prog.params, frames).numpy(),
        data["float_out"], rtol=1e-5, atol=1e-5,
        err_msg=f"{name}: float path differs from golden")
    exe = prog.compile(Options(scheme=W4A4, device="cpu"))
    np.testing.assert_allclose(
        exe.run(frames).numpy(), data["quant_out"], rtol=1e-5, atol=1e-5,
        err_msg=f"{name}: quantized device path differs from golden")
