"""CG iterations a solve: the program's ba.cg_iterations counter (each CG
loop adds the iterations it ran) over the traced window's solves."""

from benchmark import program_trace


def read(ctx):
    return program_trace.per_solve_counter("ba.cg_iterations")
