"""K2's share of its roofline over a reconstruction's launches:
bounds.seg_sum_bound_ms and camera_bound_ms of each launch's shapes,
summed, over K2's device time in the profiler's trace."""

from benchmark import readers


def read(ctx):
    return readers.roofline(ctx, readers.k2_bound_ms, readers.K2_KERNELS)
