"""The port's examples (``repro_torch.examples``) run on the CPU.

``quickstart``: the CA shape, the photonic_mvm kernel path equal to its
oracle, LeNet per frame and a chained program, an LM's finite logits; the
CA's output also bitwise against the reference's ``compressive_acquire``
on the same frame. ``imaging_demo --quick``: every pipeline through the
compiled [4:4] path, the learned head above bilinear, and edge_detect's
PSNR within 1e-6 relative of the reference's through its own API on the
same frames (the metric's float32 log10 an ulp apart).
``train_lenet_qat --steps 2``: five schemes trained, each quantized one
deployed on ``LightatorDevice.run`` with a report equal field for field to
the reference's ``LightatorDevice.run`` report for the same layers, and
logits bitwise the port's ``run_eager`` on the trained weights.
``serve_quantized_lm --gen 2``: three schemes' tokens in range.
``quickstart``'s step 3 holds ``LightatorDevice.run_eager`` bitwise to the
compiled run. ``train_lm_100m`` is in ``test_torch_train_lm.py``.
"""

from __future__ import annotations

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core.accelerator import LightatorDevice as JDevice
from repro.core import quant as jquant
from repro.kernels import dispatch as jdispatch
from repro.models.vision import lenet_ir as jlenet_ir
from repro.core.compressive import compressive_acquire as jca
from repro.core.quant import W4A4 as JW4A4
from repro.imaging import PIPELINES as JPIPELINES
from repro.imaging import apply_float as japply
from repro.imaging import psnr as jpsnr
from repro_torch.core.accelerator import LightatorDevice
from repro_torch.data.synthetic import synthetic_digits, synthetic_textures
from repro_torch.examples import (imaging_demo, quickstart,
                                  serve_quantized_lm, train_lenet_qat)
from repro_torch.weights import params_to_numpy


def test_quickstart_runs_on_the_cpu(capsys):
    out = quickstart.main(["--device", "cpu"])
    assert "quickstart OK" in capsys.readouterr().out
    assert tuple(out["ca"].shape) == (1, 128, 128)
    assert out["mvm_err"] == 0.0
    assert tuple(out["lenet"].shape) == (8, 10)
    assert tuple(out["chain"].shape) == (2, 64, 64, 1)
    assert out["eager_ok"] is True
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


def test_train_lenet_qat_deploys_on_the_device_on_the_cpu(capsys):
    rows = train_lenet_qat.main(["--steps", "2", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert [r["scheme"] for r in rows] == ["fp32", "w4a4", "w3a4", "w2a4",
                                          "mx43"]
    assert "device-exec acc on 8 frames" in printed
    jschemes = {"w4a4": jquant.W4A4, "w3a4": jquant.W3A4,
                "w2a4": jquant.W2A4, "mx43": jquant.MX_43}
    xte, _ = synthetic_digits(512, seed=9)
    frames = xte[:train_lenet_qat.DEPLOY_FRAMES]
    dev = LightatorDevice(device="cpu")
    for row in rows:
        assert len(row["losses"]) == 2 and np.isfinite(row["losses"]).all()
        if row["scheme"] == "fp32":
            assert "report" not in row
            continue
        jparams = jax.tree.map(jnp.asarray, params_to_numpy(row["params"]))
        with warnings.catch_warnings(), \
                jdispatch.use_backend("reference"):
            warnings.simplefilter("ignore", DeprecationWarning)
            _, want = JDevice().run(jlenet_ir(), jparams, jnp.asarray(frames),
                                    jschemes[row["scheme"]])
        assert dataclasses.asdict(row["report"]) == dataclasses.asdict(want)
        eager, _ = dev.run_eager(row["layers"], row["params"], frames,
                                 row["scheme_spec"])
        assert torch.equal(row["logits"], eager)


def test_serve_quantized_lm_on_the_cpu(capsys):
    out = serve_quantized_lm.main(["--gen", "2", "--device", "cpu"])
    assert sorted(out) == ["none", "w2a4", "w4a4"]
    for toks in out.values():
        assert tuple(toks.shape) == (4, serve_quantized_lm.PROMPT_LEN + 2)
        assert toks.dtype == torch.int32 and bool((toks >= 0).all())
    assert capsys.readouterr().out.count("generated 2 tokens x 4 seqs") == 3
