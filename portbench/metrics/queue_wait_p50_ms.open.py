"""queue_wait_p50_ms.open (ms): the median of the program's
``serve.request.queue_wait`` spans (submit to the batch closing) of the
requests submitted inside the window."""

import numpy as np


def read(run):
    lo, hi = run.outcome.t0 * 1e9, run.outcome.t1 * 1e9
    waits = [(s["t1_ns"] - s["t0_ns"]) / 1e6 for s in run.spans
             if s["name"] == "serve.request.queue_wait"
             and lo <= s["t0_ns"] < hi]
    return float(np.median(waits)) if waits else None
