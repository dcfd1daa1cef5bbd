"""Share of the CG iterations whose matvec ran in kernel K3: the
program's ba.cg_k3 counter over its ba.cg_iterations, a solve each.  None
for a program that does not count ba.cg_k3."""

from benchmark import program_trace


def read(ctx):
    k3 = program_trace.per_solve_counter("ba.cg_k3")
    its = program_trace.per_solve_counter("ba.cg_iterations")
    if k3 is None or not its:
        return None
    return 100.0 * k3 / its
