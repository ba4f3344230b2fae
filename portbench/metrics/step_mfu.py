"""step_mfu (%): the model's int8 operations (2 x MACs of every conv and
dense layer, from the configuration's shapes) of the frames answered in
the window, padding slots excluded, over the window's seconds times the
card's published dense int8 peak. The profiled part of a traced window
is left out (the profiler slows the host)."""

from portbench import work


def read(run):
    if run.peaks is None:
        return None
    ops = work.model_ops(run.cfg) * run.unprofiled_frames_per_s()
    return 100.0 * ops / run.peaks["int8_ops_per_s"]
