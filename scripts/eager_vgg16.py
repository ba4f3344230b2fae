"""Time VGG16 on ``LightatorDevice`` at bucket 8 on the card, as
``chip_smoke.py``'s ``[eager]`` phase runs it: ``run`` (the cached
compile and the unbound executor, which lays each conv's levels out on
every call) and ``run_eager`` (the per-layer interpreter).

    python scripts/eager_vgg16.py [--src DIR] [--iters N]

``--src`` is the ``src`` directory of the port to time (this checkout's
by default): a second checkout unpacked beside this one is timed by the
same harness in the same call (run parent, change, change, parent). The
program, frames and timing are ``chip_smoke.py``'s (``vgg16_program``,
``frames_for``, ``per_call_ms``: CUDA events, one warm-up call). Builds
the kernels of the timed tree first. Prints one JSON line: ms a call of
each (median and all), the ``run`` call's launches, and a digest of its
logits (equal digests: bitwise equal answers).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path[:0] = [str(src), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("eager_vgg16: needs a CUDA device")
    import chip_smoke
    import repro_torch
    from repro_torch.core.accelerator import LightatorDevice
    from repro_torch.core.quant import W4A4
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise SystemExit(f"eager_vgg16: repro_torch from "
                         f"{repro_torch.__file__}, not {src}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    built = _build.build()
    device = torch.device("cuda")
    prog = chip_smoke.vgg16_program()
    dev = LightatorDevice(device="cuda")
    params = dev._params(prog.params)
    frames = dev._tensor(chip_smoke.frames_for(prog, chip_smoke.BUCKET,
                                               1800))
    warnings.simplefilter("ignore", DeprecationWarning)

    def run():
        return dev.run(prog.layers, params, frames, W4A4)[0]

    def run_eager():
        return dev.run_eager(prog.layers, params, frames, W4A4)[0]

    logits = run()
    torch.cuda.synchronize()
    reset_launch_counts()
    again = run()
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    if not torch.equal(logits, again) or \
            not torch.equal(logits, run_eager()):
        raise SystemExit("eager_vgg16: run and run_eager disagree")
    run_ms = chip_smoke.per_call_ms(device, run, args.iters)
    eager_ms = chip_smoke.per_call_ms(device, run_eager, args.iters)
    print(json.dumps(dict(
        src=str(src), device=smi, torch=torch.__version__,
        build_s={k: round(v, 1) for k, v in built.items()},
        run_ms=statistics.median(run_ms), run_ms_all=run_ms,
        eager_ms=statistics.median(eager_ms), eager_ms_all=eager_ms,
        run_launches=counts,
        logits_sha256=hashlib.sha256(
            logits.cpu().numpy().tobytes()).hexdigest()[:16])), flush=True)


if __name__ == "__main__":
    main()
