"""batch_fill.closed (share): frames served over the bucket slots of the
batches served inside the window, from ``Server.stats()`` at the
window's two ends (serving layer: how much of each captured bucket
carries a frame)."""


def read(run):
    frames, slots = run.counts
    return frames / slots if slots else None
