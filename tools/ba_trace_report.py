#!/usr/bin/env python3
"""Where a bundle adjustment's time and idle go on the card, by the
program's own spans (openmvg_torch/utils/logging.py, placed in
sfm/ba.py): one traced run of the benchmark's bal-dubrovnik.refine cell
(benchmark/harness.run_cell with --trace 1, so the same CUDA-only
profiler session over the same window), then, from that session and the
program's records:

  phases_s     device-timeline seconds a solve of each LM phase (ba.cost,
               ba.jacobians, ba.schur, ba.cg, ba.backsub), their sum, and
               ba.lm_step's own
  idle_s       the window's idle seconds a solve by the innermost program
               span open at each idle gap's start ("outside" where none)
  gaps         the same idle by what the card did last and by the gap's
               length: gaps that follow a device-to-host copy (the card
               waiting for the host to act on a read) and the rest, in
               bins of length; device events a solve
  host_s       each span's host seconds a solve (t1_ns - t0_ns, summed)
  clock        each kernel launched inside a program span (the span open
               at the profiler's launch record) against the span's t0_ns,
               and each host_read span against the device-to-host copies
               of the device clock: the largest offsets seen, and the
               median of (read's t1_ns - nearest copy's end) in each second
               of the window, whose largest excursion shows how far the
               two clocks wandered apart
  metrics      the per-layer metrics of the run's result line

    python3 tools/ba_trace_report.py --seed 7 [--seconds 51] [--out FILE]

Prints one JSON object (and writes it to --out).  Needs an NVIDIA card.
"""

import argparse
import bisect
import json
import os
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CELL = "bal-dubrovnik.refine"
PHASES = ("ba.cost", "ba.jacobians", "ba.schur", "ba.cg", "ba.backsub")


class Tree:
    """The program's spans as a tree: the innermost span open at a time."""

    def __init__(self, spans):
        self.spans = spans
        kids = defaultdict(list)
        for i, s in enumerate(spans):
            if s.t1_ns is not None:
                kids[s.parent].append(i)
        self.kids = {k: (v, [spans[i].t0_ns for i in v]) for k, v in kids.items()}

    def innermost(self, t):
        node, found = None, None
        while node in self.kids:
            idx, starts = self.kids[node]
            j = bisect.bisect_right(starts, t) - 1
            if j < 0 or t >= self.spans[idx[j]].t1_ns:
                break
            node = found = idx[j]
        return found


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    from benchmark import harness, program_trace, trace
    from openmvg_torch.utils import logging as omt

    kept = []
    stop = trace.DeviceTrace.stop

    def stop_and_keep(self):
        stop(self)
        kept.append(self)

    trace.DeviceTrace.stop = stop_and_keep
    result = harness.run_cell(CELL, args.seed, args.seconds, 1)
    trace.DeviceTrace.stop = stop
    dtrace, = kept
    spans = omt.records()["spans"]
    n = sum(s.name == program_trace.SOLVE for s in spans)
    tree = Tree(spans)

    phases = {k: sum(s.device_s for s in spans if s.name == k) / n
              for k in PHASES + ("ba.lm_step",)}
    phases["sum of the phases"] = sum(phases[k] for k in PHASES)

    # each idle gap by the innermost span open at its start, by the device
    # event that ended last before it, and by its length
    idle = defaultdict(float)
    gaps = defaultdict(lambda: [0, 0.0])
    end, last = dtrace.t0, None
    for name, s, e in dtrace.events + [("", dtrace.t1, dtrace.t1)]:
        s, e = max(s, dtrace.t0), min(e, dtrace.t1)
        if s > end:
            i = tree.innermost(end)
            idle[spans[i].name if i is not None else "outside"] += (s - end) * 1e-9 / n
            us = (s - end) * 1e-3
            size = ("<5us" if us < 5 else "5-50us" if us < 50 else
                    "50-500us" if us < 500 else ">=500us")
            g = gaps[("after a DtoH copy" if last and "DtoH" in last else "other") + " " + size]
            g[0] += 1 / n
            g[1] += (s - end) * 1e-9 / n
        if e > end:
            end, last = e, name
    host = defaultdict(float)
    for s in spans:
        host[s.name] += (s.t1_ns - s.t0_ns) * 1e-9 / n

    # the clock: kernels by their launch record's span, reads by their copies
    dev = torch.autograd.DeviceType.CUDA
    events = list(dtrace.prof.profiler.kineto_results.events())
    launch = {e.correlation_id(): e.start_ns() for e in events
              if e.device_type() != dev and e.correlation_id() > 0}
    kernels, late, worst_kernel = 0, 0, None
    copies = []
    for e in events:
        if e.device_type() != dev:
            continue
        if "DtoH" in e.name():
            copies.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        t_launch = launch.get(e.correlation_id())
        i = tree.innermost(t_launch) if t_launch is not None else None
        if i is None:
            continue
        kernels += 1
        off = spans[i].t0_ns - e.start_ns()        # > 0: started before its span
        late += off > 0
        worst_kernel = off if worst_kernel is None else max(worst_kernel, off)
    copies.sort()
    starts = [c[0] for c in copies]
    ends = sorted(c[1] for c in copies)
    reads, worst_read, held = 0, None, 0
    per_second = defaultdict(list)
    for s in spans:
        if s.name != program_trace.READ:
            continue
        reads += 1
        j = bisect.bisect_left(starts, s.t0_ns)
        near = [copies[k] for k in (j - 1, j) if 0 <= k < len(copies)]
        off = min(max(s.t0_ns - a, b - s.t1_ns, 0) for a, b in near) if near else None
        held += off == 0
        if off is not None:
            worst_read = off if worst_read is None else max(worst_read, off)
        j = bisect.bisect_right(ends, s.t1_ns)
        near = [ends[k] for k in (j - 1, j) if 0 <= k < len(ends)]
        if near:
            per_second[(s.t1_ns - dtrace.t0) // 10**9].append(
                min((s.t1_ns - b for b in near), key=abs))
    medians = [sorted(v)[len(v) // 2] for v in per_second.values()]

    out = dict(cell=CELL, seed=args.seed, device=torch.cuda.get_device_name(0),
               solves=n, window_s=dtrace.window_s, busy_s=dtrace.busy_s(),
               phases_s=phases, idle_s=dict(sorted(idle.items(), key=lambda kv: -kv[1])),
               gaps={k: dict(count=c, s=t) for k, (c, t) in sorted(gaps.items())},
               events_a_solve=len(dtrace.events) / n,
               host_s=dict(sorted(host.items(), key=lambda kv: -kv[1])),
               clock=dict(kernels_in_spans=kernels, kernels_before_their_span=late,
                          largest_kernel_lead_ns=worst_kernel, host_reads=reads,
                          reads_holding_their_copy=held, largest_copy_outside_read_ns=worst_read,
                          read_minus_copy_median_ns=dict(
                              least=min(medians), most=max(medians),
                              seconds_beyond_50us=sum(abs(m) > 50_000 for m in medians),
                              seconds=len(medians))),
               metrics={k: v["value"] for k, v in result["metrics"].items()},
               correct=result["correct"], checks=result["checks"])
    text = json.dumps(out, indent=1, default=float)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
