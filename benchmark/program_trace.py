"""Reductions over what the program records about itself in a traced
run: the spans and counters of openmvg_torch.utils.logging.records(),
kept while the benchmark's profiler session records, and stamped on
time.time_ns(), the clock of trace.DeviceTrace's events.  A solve is one
`ba.adjust` span.  Each function returns None where the program recorded
nothing (off the card, where no session runs) or keeps no records (a
program older than its spans), so the metric is left out.
"""

import bisect

SOLVE = "ba.adjust"
READ = "host_read"


def program_records():
    """The program's records, or None where it kept no span."""
    from openmvg_torch.utils import logging as omt_logging

    read = getattr(omt_logging, "records", None)
    recs = read() if read is not None else None
    return recs if recs and recs["spans"] else None


def _solves(recs):
    return sum(s.name == SOLVE for s in recs["spans"])


def per_solve_counter(name):
    """The counter's total over the solves recorded."""
    recs = program_records()
    if recs is None or name not in recs["counters"] or not _solves(recs):
        return None
    return recs["counters"][name] / _solves(recs)


def per_solve_spans(name):
    """The number of spans called `name` inside a solve, over the solves."""
    recs = program_records()
    if recs is None or not _solves(recs):
        return None
    spans = recs["spans"]
    solve = []           # the index of each span's enclosing solve, or None
    for i, s in enumerate(spans):
        solve.append(i if s.name == SOLVE else
                     solve[s.parent] if s.parent is not None else None)
    return sum(s.name == name and solve[i] is not None
               for i, s in enumerate(spans)) / _solves(recs)


def per_solve_device_s(name):
    """The device-timeline seconds of the spans called `name`, summed, over
    the solves; None where a span has none."""
    recs = program_records()
    if recs is None or not _solves(recs):
        return None
    secs = [s.device_s for s in recs["spans"] if s.name == name]
    if not secs or None in secs:
        return None
    return sum(secs) / _solves(recs)


def accepted_share():
    """100 x ba.lm_accepted over the ba.lm_step spans."""
    recs = program_records()
    if recs is None:
        return None
    steps = sum(s.name == "ba.lm_step" for s in recs["spans"])
    if not steps or "ba.lm_accepted" not in recs["counters"]:
        return None
    return 100.0 * recs["counters"]["ba.lm_accepted"] / steps


def idle_gaps(trace):
    """The window's idle gaps (start_ns, end_ns): the stretches between the
    device events' merged intervals, and at either end of the window.
    Together they are window_s - busy_s."""
    gaps, prev = [], trace.t0
    for s, e in trace.intervals() + [[trace.t1, trace.t1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    return gaps


def _covers(recs, name):
    """A test of whether a time lies in a closed span called `name`."""
    merged = []
    for s in sorted((s for s in recs["spans"] if s.name == name and s.t1_ns is not None),
                    key=lambda s: s.t0_ns):
        if merged and s.t0_ns <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s.t1_ns)
        else:
            merged.append([s.t0_ns, s.t1_ns])
    starts = [m[0] for m in merged]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < merged[i][1]
    return inside


def idle_share(ctx, within, excluding=None):
    """100 x the idle seconds in gaps that start inside a span called
    `within` (anywhere where None) and not inside one called `excluding`,
    over the window's seconds."""
    tr = ctx["trace"]
    recs = program_records()
    if tr is None or not tr.events or recs is None:
        return None
    inside = _covers(recs, within) if within else (lambda t: True)
    outside = _covers(recs, excluding) if excluding else (lambda t: False)
    idle = sum(e - s for s, e in idle_gaps(tr) if inside(s) and not outside(s))
    return 100.0 * idle / (tr.t1 - tr.t0)
