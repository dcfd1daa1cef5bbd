"""Share of the traced window in idle gaps of the card (the union of the
profiler's device events) that start inside one of the program's
host_read spans: the card drained its queue while the host waited on
it."""

from benchmark import program_trace


def read(ctx):
    return program_trace.idle_share(ctx, program_trace.READ)
