"""Quickstart: the Lightator stack on the port in a few steps.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. capture a frame, run the Compressive Acquisitor (fused gray + pool);
2. a photonic-quantized MVM through the photonic_mvm kernel, against its
   oracle;
3. compile LeNet through ``Program.from_model`` / ``compile(Options)`` and
   run it per frame (the per-frame-calibrated served path), the same frame
   on ``LightatorDevice``'s eager interpreter (bitwise the compiled
   ``run``), then a chain of two imaging pipelines as one program;
4. an LM architecture (smoke size) under the photonic [4:4] fake-quant.

The reference's ``examples/quickstart.py`` on the port's API.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import torch

from repro_torch import Options, Program
from repro_torch.configs import smoke_variant
from repro_torch.core.accelerator import LightatorDevice
from repro_torch.core.compressive import compressive_acquire
from repro_torch.core.program import resolve_device
from repro_torch.core.quant import MX_43, W4A4
from repro_torch.kernels.photonic_mvm.ops import photonic_mvm
from repro_torch.kernels.photonic_mvm.ref import photonic_mvm_ref
from repro_torch.models import lm as lm_mod


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    def uniform(seed, shape):
        g = torch.Generator(device=device).manual_seed(seed)
        return torch.rand(shape, generator=g, device=device)

    # -- 1. sensor: frame -> compressive acquisition -----------------------
    frame = uniform(0, (1, 256, 256, 3))                  # the 256x256 imager
    compressed = compressive_acquire(frame, pool=2)       # fused gray+pool
    print(f"CA: {tuple(frame.shape)} -> {tuple(compressed.shape)} "
          f"(one optical cycle per {96 * 3} outputs)")

    # -- 2. the optical core's MVM as a CUDA kernel ------------------------
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((32, 512), generator=g, device=device)
    w = torch.randn((512, 256), generator=g, device=device) * 0.1
    mvm_err = float((photonic_mvm(x, w, W4A4)
                     - photonic_mvm_ref(x, w, W4A4)).abs().max())
    print(f"photonic_mvm [4:4]: max|kernel - oracle| = {mvm_err:.2e}")

    # -- 3. a full model through the one front door ------------------------
    # Program (layer IR + params + frame shape) -> compile(Options)
    prog = Program.from_model(
        "lenet", generator=torch.Generator().manual_seed(2))
    exe = prog.compile(Options(scheme=MX_43, device=str(device)))
    digit = uniform(3, (1, 28, 28, 1))
    logits = exe.run_per_frame(digit)
    r = exe.report
    print(f"LeNet on Lightator-MX: logits {tuple(logits.shape)}, "
          f"{r.exec_time_s * 1e6:.2f} us/frame, {r.avg_power_w:.2f} W, "
          f"{r.kfps_per_w:.0f} kFPS/W")
    # the device simulator's per-layer interpreter: the specification the
    # compiled plan matches bit for bit (logits and report)
    eager, eager_report = LightatorDevice(device=str(device)).run_eager(
        prog.layers, prog.params, digit, MX_43)
    eager_ok = (torch.equal(eager, exe.run(digit))
                and dataclasses.asdict(eager_report)
                == dataclasses.asdict(r))
    print(f"LightatorDevice.run_eager == compiled run: {eager_ok}")
    batch_logits = exe.run_per_frame(uniform(6, (8, 28, 28, 1)))
    print(f"compiled plan: {len(exe.plan.schedules)} schedules cached, "
          f"batched logits {tuple(batch_logits.shape)}")

    # imaging pipelines are Programs too, and chain into one compiled plan
    chain = (Program.from_pipeline("denoise_box", 64, 64, 3)
             .then(Program.from_pipeline("edge_detect", 64, 64, 3)))
    out = chain.compile(Options(scheme=W4A4, device=str(device))).run(
        uniform(7, (2, 64, 64, 3)))
    print(f"chained {chain.name}: {tuple(out.shape)} in a single plan")

    # -- 4. the paper's technique on an LM architecture --------------------
    cfg = dataclasses.replace(smoke_variant("tinyllama-1.1b"),
                              quant_scheme="w4a4")
    params = lm_mod.init_lm(torch.Generator(device=device).manual_seed(4),
                            cfg, device=device)
    toks = torch.randint(0, cfg.vocab, (2, 16), device=device,
                         generator=torch.Generator(device=device)
                         .manual_seed(5))
    lm_logits, _ = lm_mod.lm_forward(params, {"tokens": toks}, cfg)
    finite = bool(torch.isfinite(lm_logits.float()).all())
    print(f"tinyllama-smoke W4A4: logits {tuple(lm_logits.shape)} "
          f"finite={finite}")
    print("quickstart OK")
    return {"ca": compressed, "mvm_err": mvm_err, "lenet": batch_logits,
            "eager_ok": eager_ok,
            "chain": out, "lm_logits": lm_logits}


if __name__ == "__main__":
    main()
