"""torch_ops_us_per_frame (us/frame): device time, inside the traced
window, of the kernels that are not the port's own (PyTorch's: the
im2col gather, casts, the head's dequant), over the frames answered in
that window. The port's kernels are the functions of an anonymous
namespace in ``csrc/``."""

import re

PORT_KERNEL = re.compile(r"^(void )?\(anonymous namespace\)::")


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.profiled
    frames = run.outcome.frames_answered(lo, hi)
    if not frames:
        return None
    seconds = sum(e["end"] - e["ts"] for e in run.trace.device
                  if e["cat"] == "kernel"
                  and not PORT_KERNEL.search(e["name"])) / 1e6
    return seconds / frames * 1e6
