"""K1's share of its roofline over a reconstruction's launches: the least
time of each launch's shapes (bounds.two_nn_bound_ms at the published
H100 peaks), summed, over K1's device time in the profiler's trace."""

from benchmark import readers


def read(ctx):
    return readers.roofline(ctx, readers.k1_bound_ms, readers.K1_KERNELS)
