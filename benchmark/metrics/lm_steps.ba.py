"""LM steps a solve: the benchmark's count of sfm.ba.lm_step calls, the
mean over the traced window's solves."""

from benchmark import readers


def read(ctx):
    return readers.per_unit_counter(ctx, "lm_steps")
