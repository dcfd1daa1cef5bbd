"""Share of the traced window in idle gaps of the card that start inside
one of the program's ba.adjust spans but not inside a host_read: the
host's issue of work fell behind the card.  device_idle.ba less this and
idle_read.ba is the idle outside the solves."""

from benchmark import program_trace


def read(ctx):
    return program_trace.idle_share(ctx, program_trace.SOLVE, excluding=program_trace.READ)
