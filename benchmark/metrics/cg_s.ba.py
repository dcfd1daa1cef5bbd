"""Device seconds of the CG loops a solve: the device timeline of the
program's ba.cg spans (CUDA events at their entry and exit), summed,
over the solves."""

from benchmark import program_trace


def read(ctx):
    return program_trace.per_solve_device_s("ba.cg")
