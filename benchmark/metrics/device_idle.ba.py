"""Share of the traced window (BAL solves) in which no operation runs on
the card, from the profiler's device events."""

from benchmark import readers


def read(ctx):
    return readers.device_idle(ctx)
