"""Seconds a reconstruction spends in the sfm stage: the benchmark's span
around that cli.main call, the mean over the traced window's
reconstructions."""

from benchmark import readers


def read(ctx):
    return readers.per_unit_spans(ctx, "stage.sfm")
