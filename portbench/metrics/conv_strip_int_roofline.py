"""conv_strip_int_roofline (%): the int8 strip conv's least time over its
device time, over the traced window's whole batches. The work is that of
the layers the compiled plan routes to it (``strip_routes`` "int"), at
each batch's bucket; the time is that of its kernels (the mma.sync and
wgmma forms, the folded store included)."""

SYMBOLS = r"conv_igemm_(fold_|wgmma_)?kernel"


def read(run):
    return run.roofline_share("conv_strip_int", SYMBOLS)
