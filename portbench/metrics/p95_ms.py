"""p95_ms (ms): the 95th percentile of the latency of every request due
in the window, each from its due time on the arrival schedule to its
answer; a refused, failed or unanswered request counts as infinitely
late (then the percentile is the longest wait the run allows)."""

import numpy as np


def read(run):
    lat = run.outcome.latencies_ms()
    if lat.size == 0:
        return None
    cap = (run.outcome.t1 + 60.0 - run.outcome.t0) * 1e3
    return float(np.percentile(np.minimum(lat, cap), 95))
