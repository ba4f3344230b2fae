#!/usr/bin/env python3
"""Host-side costs of one bound bucket-8 batch on the card.

    PYTHONPATH=src python3 scripts/host_path_costs.py [--pipeline edge_detect]

For an imaging pipeline at 256x256x3 (one 6.3 MB bucket-8 batch), times
with a host clock around work that ends in a synchronize, mean of 20:

  * the scheduler's ``np.concatenate`` of eight single-frame requests;
  * a numpy copy of the batch into pageable and into pinned memory (the
    staging slot);
  * ``torch.empty(pin_memory=True)`` of one answer when every block is
    still held (a new page-locked allocation) and when it is released
    (a block from PyTorch's caching host allocator);
  * one replay of the bucket's CUDA graph;
  * a bound view's ``run_padded`` + ``wait`` against the unbound eager
    ``run_padded`` + ``.cpu()``.

Prints the card's name and power limit, one line per measurement and a
JSON object of them all. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def main(argv=None) -> int:
    import numpy as np
    import torch
    from repro_torch import Options, Program

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pipeline", default="edge_detect")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("host_path_costs: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    prog = Program.from_pipeline(args.pipeline, 256, 256, 3)
    exe = prog.compile(Options())
    bound = exe.bind("cuda", staging_slots=2)
    bound.warm((8,))
    frames = np.random.default_rng(0).random(
        (8, 256, 256, 3)).astype(np.float32)
    requests = [frames[i:i + 1] for i in range(8)]
    out_shape = (8, *prog.output_hwc)
    results = {}

    def timed(label, fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        torch.cuda.synchronize()
        results[label] = (time.perf_counter() - t0) / args.iters * 1e3
        print(f"{label}: {results[label]:.3f} ms", flush=True)

    held = []
    pageable = np.empty_like(frames)
    pinned = torch.empty(frames.shape, pin_memory=True).numpy()
    graph = bound._binding.graphs[8]
    timed("concatenate_8_requests", lambda: np.concatenate(requests))
    timed("copy_batch_to_pageable",
          lambda: pageable.__setitem__(slice(None), frames))
    timed("copy_batch_to_pinned",
          lambda: pinned.__setitem__(slice(None), frames))
    timed("pinned_answer_alloc_held", lambda: held.append(
        torch.empty(out_shape, pin_memory=True)))
    held.clear()
    timed("pinned_answer_alloc_cached",
          lambda: torch.empty(out_shape, pin_memory=True))
    timed("graph_replay", graph.replay)
    timed("bound_run_padded_wait",
          lambda: bound.run_padded(frames, 8).wait())
    timed("eager_run_padded_cpu",
          lambda: exe.run_padded(frames, 8).cpu().numpy())
    print(json.dumps({"pipeline": args.pipeline, "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
