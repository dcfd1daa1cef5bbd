"""Device-to-host reads a solve: the program's host_read spans inside its
ba.adjust spans (the CG loop's stopping tests, LM's cost, accept and
damping, the start's cost and camera test) over the solves."""

from benchmark import program_trace


def read(ctx):
    return program_trace.per_solve_spans(program_trace.READ)
