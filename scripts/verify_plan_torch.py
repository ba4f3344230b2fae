#!/usr/bin/env python
"""Plan-verifier CLI of the PyTorch port: prove the kernel invariants for
the registered programs, on the CPU (no card needed).

Compiles every requested model or imaging pipeline with
``Options(device="cpu", verify="off")`` and runs
``repro_torch.analysis.verify_plan`` over the plan itself: the
``|acc| < 2^24`` integer-exactness proof (with per-step headroom in bits),
the shape-legality re-walk, and the strip and fusion audit, the Hopper
launch geometry included (the code glossary is ``docs/analysis.md``).

    python scripts/verify_plan_torch.py --all      # lenet, vgg9, vgg16 at
                                                   # their input sizes; the
                                                   # pipelines at 64 and 256
    python scripts/verify_plan_torch.py --model vgg16 -v
    python scripts/verify_plan_torch.py --pipeline edge_detect --size 128

Exit code 1 if any target gives an error-severity diagnostic (or fails to
compile); warnings are printed but do not fail it.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

ALL_SIZES = (64, 256)


def _verify_one(name: str, program, verbose: bool) -> int:
    """Compile and verify one program; returns the number of errors."""
    from repro_torch import Options, analysis

    try:
        # verify="off": the verifier runs here, so that the info-level
        # headroom report and every finding are printed, not the first
        # compile error alone
        exe = program.compile(Options(device="cpu", verify="off"))
    except Exception as e:                      # the compile itself failed
        print(f"verify_plan_torch: {name}: COMPILE FAILED — {e}")
        return 1
    diags = analysis.verify_plan(exe.plan)
    errs = analysis.errors(diags)
    warns = [d for d in diags if d.severity == "warning"]
    headrooms = [float(d.message.split("headroom ")[1].split(" bits")[0])
                 for d in diags if d.code == "LTR003"]
    hr = f", min headroom {min(headrooms):.2f} bits" if headrooms else ""
    print(f"verify_plan_torch: {name}: {'FAIL' if errs else 'OK'} "
          f"({len(diags)} finding(s), {len(errs)} error(s), "
          f"{len(warns)} warning(s){hr})")
    for d in diags:
        if verbose or d.severity != "info":
            print(f"  {d}")
    return len(errs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all", action="store_true",
                    help="every registered model, and every pipeline at "
                         f"{' and '.join(map(str, ALL_SIZES))}")
    ap.add_argument("--model", action="append", default=[],
                    help="a registered CNN (lenet/vgg9/vgg16); repeatable")
    ap.add_argument("--pipeline", action="append", default=[],
                    help="a registered imaging pipeline; repeatable")
    ap.add_argument("--size", type=int, default=64,
                    help="pipeline frame size (default 64)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print info-level findings (per-step headroom)")
    args = ap.parse_args(argv)

    from repro_torch import Program
    from repro_torch.imaging import PIPELINES
    from repro_torch.models.vision import MODEL_INPUT_HWC

    models = list(args.model)
    pipelines = [(name, args.size) for name in args.pipeline]
    if args.all:
        models = sorted(MODEL_INPUT_HWC)
        pipelines = [(name, size) for size in ALL_SIZES
                     for name in sorted(PIPELINES)]
    if not models and not pipelines:
        ap.error("nothing to verify: pass --all, --model or --pipeline")

    errors = 0
    for name in models:
        # the static pass needs no weights: compile schedule-only
        errors += _verify_one(name, Program.from_model(name, params={}),
                              args.verbose)
    for name, size in pipelines:
        errors += _verify_one(f"{name}@{size}",
                              Program.from_pipeline(name, size, size, 3),
                              args.verbose)
    n = len(models) + len(pipelines)
    if errors:
        print(f"verify_plan_torch: FAIL — {errors} error(s) across {n} "
              f"target(s)", file=sys.stderr)
        return 1
    print(f"verify_plan_torch: OK ({n} target(s) proved |acc| < 2^24, "
          f"shapes legal, strip and fusion audit clean)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
