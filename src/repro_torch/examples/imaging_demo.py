"""Versatile image processing through the port, every pipeline.

    PYTHONPATH=src python -m repro_torch.examples.imaging_demo [--quick] \
        [--device cpu]

Runs every fixed-function pipeline of ``repro_torch.imaging.PIPELINES``
on a synthetic RGB scene twice: through the float oracle
(``apply_float``) and through the compiled quantized path ([4:4],
``Program.compile(Options)`` then ``Executable.run``, one calibration
for the batch). Prints a
quality / power table, a denoise -> edge chain compiled as one plan, then
trains the ``compress_recon_deconv`` head and shows the reconstruction
PSNR against plain bilinear. ``--quick`` shrinks frames and steps. The
reference's ``examples/imaging_demo.py`` on the port's API.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from repro_torch import Options, Program
from repro_torch.core.program import resolve_device
from repro_torch.core.quant import W4A4
from repro_torch.data.synthetic import synthetic_textures
from repro_torch.imaging import (PIPELINES, apply_float, fit_recon_head,
                                 gray_target, psnr, ssim)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small frames / few training steps (CI smoke)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    hw, batch, steps = (32, 2, 30) if args.quick else (64, 8, 150)

    imgs, _ = synthetic_textures(batch, hw=hw, seed=0)
    frames = torch.from_numpy(imgs).to(device)
    options = Options(scheme=W4A4, device=str(device))
    out = {"psnr": {}}

    print(f"{'pipeline':24s} {'out':>14s} {'PSNR':>8s} {'SSIM':>7s} "
          f"{'dev FPS':>12s} {'kFPS/W':>9s}")
    for name, pipe in PIPELINES.items():
        prog = pipe.program(hw, hw, 3)
        exe = prog.compile(options)
        got = exe.run(frames)
        ref = apply_float(prog.layers, prog.params, frames)
        r = exe.report
        out["psnr"][name] = float(psnr(ref, got))
        print(f"{name:24s} {str(tuple(got.shape[1:])):>14s} "
              f"{out['psnr'][name]:7.2f}d {float(ssim(ref, got)):7.4f} "
              f"{r.fps:12,.0f} {r.kfps_per_w:9.1f}")

    # program composition: denoise -> edge detect as one compiled plan
    chain = (PIPELINES["denoise_gauss"].program(hw, hw, 3)
             .then(PIPELINES["edge_detect"].program(hw, hw, 3)))
    exe = chain.compile(options)
    got = exe.run(frames)
    ref = apply_float(chain.layers, chain.params, frames)
    out["chain_psnr"] = float(psnr(ref, got))
    print(f"\n[chain] {chain.name}: {len(exe.plan.schedules)} schedules in "
          f"one plan, PSNR {out['chain_psnr']:.2f} dB, "
          f"{exe.report.fps:,.0f} dev FPS")

    # learned reconstruction: fit the deconv head, compare with bilinear
    prog = PIPELINES["compress_recon_deconv"].program(hw, hw, 3)
    tgt = gray_target(frames)
    before = apply_float(prog.layers, prog.params, frames)
    fitted = fit_recon_head(prog.layers, prog.params, frames, steps=steps,
                            device=device)
    after = apply_float(prog.layers, fitted, frames)
    dev_after = Program(prog.layers, fitted, prog.input_hwc,
                        name=prog.name).compile(options).run(frames)
    out["recon_psnr"] = {"bilinear": float(psnr(tgt, before)),
                         "trained": float(psnr(tgt, after)),
                         "trained_device": float(psnr(tgt, dev_after))}
    print(f"\n[recon] bilinear       {out['recon_psnr']['bilinear']:.2f} dB "
          f"vs original (float)")
    print(f"[recon] + trained head {out['recon_psnr']['trained']:.2f} dB "
          f"vs original (float)")
    print(f"[recon] + trained head {out['recon_psnr']['trained_device']:.2f}"
          f" dB vs original (quantized device, {W4A4.name})")
    return out


if __name__ == "__main__":
    main()
