"""Find an open-loop cell's knee: one set-up, then the cell's traffic at
each offered rate in turn.

    python3 portbench/sweep.py --workload vgg16-w4a4.sensors-open \
        --seed 1 --seconds 4 --rates 400 600 800 1000

For each rate, one JSON line: requests/s and frames/s offered and
answered, the backlog left at the window's end (requests due and not yet
answered), the latency's median and 95th percentile over the first and
the last third of the window (a growing backlog shows as the last third
waiting longer), and how late the generator submitted. The knee is the
highest rate whose backlog does not grow.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def summary(outcome, rate):
    import numpy as np
    sel = outcome.in_window()
    due, done, ok = outcome.due[sel], outcome.done[sel], outcome.ok[sel]
    lat = outcome.latencies_ms()
    span = outcome.t1 - outcome.t0
    third = span / 3

    def pct(mask, q):
        v = lat[mask]
        return float(np.percentile(v, q)) if v.size else None

    first = due < outcome.t0 + third
    last = due >= outcome.t1 - third
    late = (outcome.sent[sel] - due) * 1e3
    return {
        "rate_rps": rate,
        "offered_fps": float(outcome.frames[sel].sum() / span),
        "answered_rps": float((ok & (done < outcome.t1)).sum() / span),
        "answered_fps": outcome.frames_answered() / span,
        "backlog_at_end": int((~(done < outcome.t1)).sum()),
        "failed": int((~ok).sum()),
        "p50_first_ms": pct(first, 50), "p50_last_ms": pct(last, 50),
        "p95_first_ms": pct(first, 95), "p95_last_ms": pct(last, 95),
        "p95_ms": float(np.percentile(lat, 95)) if lat.size else None,
        "generator_late_p99_ms": float(np.nanpercentile(late, 99)),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--rates", type=float, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import time
    from portbench import harness, manifest
    cell = manifest.cell(manifest.load(ROOT), args.workload)
    cfg = manifest.config(cell["config"], ROOT)
    wl = manifest.workload(args.workload, ROOT)
    session = harness.Session(cfg, wl, args.seed, "cuda")
    try:
        for rate in args.rates:
            outcome = session.drive(args.seconds, time.perf_counter(),
                                    rate_rps=rate)
            print(json.dumps(summary(outcome, rate)), flush=True)
    finally:
        session.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
