"""Share of LM steps accepted: the program's ba.lm_accepted counter over
its ba.lm_step spans."""

from benchmark import program_trace


def read(ctx):
    return program_trace.accepted_share()
