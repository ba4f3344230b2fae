"""photonic_mvm_roofline (%): photonic_mvm's least time over its device
time, over the traced window's whole batches. The work is that of the
layers the compiled plan runs on it (resident convs, read as their
im2col patch matrices, and dense layers), at each batch's bucket; the
time is that of all its kernel forms."""

SYMBOLS = r"mvm_(gemm|stream|wgmma|skinny|layout)_kernel"


def read(run):
    return run.roofline_share("photonic_mvm", SYMBOLS, im2col=True)
