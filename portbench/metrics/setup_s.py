"""setup_s (s): process start to the first timed request, on the host
clock: CUDA start, the weights and frames, the compile and its verifier,
binding (weights laid out, one CUDA graph captured a bucket, the kernels
built or loaded) and the lead-in of the cell's own traffic."""


def read(run):
    return run.setup_s
