"""The port's examples (``repro_torch.examples``) run on the CPU.

``quickstart``: the CA shape, the photonic_mvm kernel path equal to its
oracle, LeNet per frame and a chained program, an LM's finite logits; the
CA's output also bitwise against the reference's ``compressive_acquire``
on the same frame. ``imaging_demo --quick``: every pipeline through the
compiled [4:4] path, the learned head above bilinear, and edge_detect's
PSNR within 1e-6 relative of the reference's through its own API on the
same frames (the metric's float32 log10 an ulp apart).
``train_lm_100m`` is in ``test_torch_train_lm.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core.compressive import compressive_acquire as jca
from repro.core.quant import W4A4 as JW4A4
from repro.imaging import PIPELINES as JPIPELINES
from repro.imaging import apply_float as japply
from repro.imaging import psnr as jpsnr
from repro_torch.data.synthetic import synthetic_textures
from repro_torch.examples import imaging_demo, quickstart


def test_quickstart_runs_on_the_cpu(capsys):
    out = quickstart.main(["--device", "cpu"])
    assert "quickstart OK" in capsys.readouterr().out
    assert tuple(out["ca"].shape) == (1, 128, 128)
    assert out["mvm_err"] == 0.0
    assert tuple(out["lenet"].shape) == (8, 10)
    assert tuple(out["chain"].shape) == (2, 64, 64, 1)
    assert bool(torch.isfinite(out["lm_logits"]).all())
    frame = torch.rand((1, 256, 256, 3),
                       generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(
        out["ca"].numpy(), np.asarray(jca(jnp.asarray(frame.numpy()), 2)))


def test_imaging_demo_quick_on_the_cpu():
    out = imaging_demo.main(["--quick", "--device", "cpu"])
    assert set(out["psnr"]) == set(JPIPELINES)
    assert all(np.isfinite(v) for v in out["psnr"].values())
    r = out["recon_psnr"]
    assert r["trained"] > r["bilinear"]
    imgs, _ = synthetic_textures(2, hw=32, seed=0)
    prog = JPIPELINES["edge_detect"].program(32, 32, 3)
    frames = jnp.asarray(imgs)
    want = jpsnr(japply(prog.layers, prog.params, frames),
                 prog.compile(repro.Options(scheme=JW4A4)).run(frames))
    # the served outputs are held bitwise elsewhere (test_torch_imaging);
    # the metric's float32 log10 differs by an ulp
    assert out["psnr"]["edge_detect"] == pytest.approx(float(want), rel=1e-6)
