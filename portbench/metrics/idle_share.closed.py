"""idle_share (%): the share of the traced window in which nothing ran on
the card: 1 - (union of its kernel, copy and memset intervals) / window."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
