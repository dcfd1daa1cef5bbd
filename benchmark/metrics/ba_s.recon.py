"""Seconds of bundle adjustment a reconstruction: the benchmark's spans
around each sfm.ba.adjust call (it ends in a host read), summed a
reconstruction, the mean over the traced window."""

from benchmark import readers


def read(ctx):
    return readers.per_unit_spans(ctx, "ba.adjust")
