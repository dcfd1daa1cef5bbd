"""Seconds a reconstruction spends in the features, matches and filter
stages: the benchmark's spans around those cli.main calls, the mean over
the traced window's reconstructions."""

from benchmark import readers


def read(ctx):
    return readers.per_unit_spans(ctx, "stage.features", "stage.matches", "stage.filter")
