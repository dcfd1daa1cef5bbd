"""Share of the Jacobians' chunks that a closed form computed (pinhole or
the polynomial camera kinds 2-4, not forward mode): the program's
ba.jac_closed counter over its ba.jac_chunks, a solve each.  None for a
program that does not count ba.jac_closed."""

from benchmark import program_trace


def read(ctx):
    closed = program_trace.per_solve_counter("ba.jac_closed")
    chunks = program_trace.per_solve_counter("ba.jac_chunks")
    if closed is None or not chunks:
        return None
    return 100.0 * closed / chunks
