"""The correctness check's readings: how far the control lands from the
reference.

    python3 portbench/control.py --config vgg16-w4a4 --seeds 1 2 3 \
        --frames 64

For each seed: the configuration's weights and frames as a run makes
them, the plain reference's logits at the configuration's precision, and
the same reference computed one step lower -- its requants in bfloat16
(``bfloat16``), or its weights one bit narrower (``w_bits-1``) -- put in
the program's place and judged by the run's own check
(``harness.logit_gap`` against the reference at the configuration's
precision, ``harness.is_correct`` against the limits): each has to come
out not correct. The smallest reading of the controls over the seeds is
the upper reading a limit is set below. Prints one JSON line a seed and
a summary line.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cfg, seed, frames, device, block):
    """{control: the numbers ``harness.check`` compares, and whether a run
    answering with the control would be correct}, over ``frames`` frames
    drawn from ``seed``."""
    import numpy as np
    import torch
    from portbench import harness, model
    from portbench.reference.cnn import Reference
    gen = torch.Generator(device=device)
    gen.manual_seed(model.torch_seed(seed))
    params = model.make_weights(cfg, gen, device)
    per = 1
    if cfg["frames"]["kind"] == "tiles":
        fh, fw = cfg["frames"]["frame_hw"]
        per = (fh // cfg["input_hwc"][0]) * (fw // cfg["input_hwc"][1])
    pool = model.make_frames(cfg, -(-frames // per), gen, device)
    x = pool.reshape((-1,) + tuple(cfg["input_hwc"]))[:frames]
    w, a = cfg["scheme"]["w_bits"], cfg["scheme"]["a_bits"]
    controls = {"bfloat16": Reference(cfg["layers"], params, w, a,
                                      precision="bfloat16"),
                "w_bits-1": Reference(cfg["layers"], params, w - 1, a)}
    out = {}
    for name, ctl in controls.items():
        answers = np.concatenate([
            ctl.logits(torch.from_numpy(x[lo:lo + block]).to(device))
            .cpu().numpy() for lo in range(0, len(x), block)])
        # the control in the program's place, judged by the run's check
        numbers = {"logit_gap": harness.logit_gap(cfg, params, x, answers,
                                                  device, block),
                   "unanswered": 0}
        out[name] = {**numbers, "correct": harness.is_correct(numbers, cfg)}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--frames", type=int, required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import manifest
    cfg = manifest.config(args.config, ROOT)
    device = torch.device(args.device)
    lows = {}
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(cfg, seed, args.frames, device, cfg["check"]["block"])
        print(json.dumps({"config": args.config, "seed": seed,
                          "frames": args.frames, **r,
                          "seconds": time.perf_counter() - t}), flush=True)
        for k, v in r.items():
            lows[k] = min(lows.get(k, v["logit_gap"]), v["logit_gap"])
    print(json.dumps({"config": args.config, "smallest": lows,
                      "limit": cfg["check"]["logit_gap"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
