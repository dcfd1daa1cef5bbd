"""What a traced run records: the benchmark's own spans and counters
around the program's calls, the shapes of each kernel call, and one
torch.profiler session over the measured window (CUDA activity only:
with CPU activity on, the profiler would record each of the engines'
~10^6 small host ops and slow the window it measures).

Span times are host wall-clock nanoseconds (time.time_ns), the clock
the profiler stamps its device events with, so an idle gap on the
device can be named by the span the host was in.
"""

import time
from collections import defaultdict


class Recorder:
    """Spans, counters and kernel-call records of one run.  With
    `active` false every method is a no-op, so the untraced run pays
    nothing."""

    def __init__(self, active):
        self.active = active
        self.spans = []                  # (name, t0_ns, t1_ns, unit index)
        self.counters = defaultdict(list)  # name -> one value per unit
        self.calls = defaultdict(list)   # kernel -> records of its launches
        self.unit = 0                    # index of the reconstruction / solve
        self.units = 0                   # units completed inside the traced window
        self._open = []

    def span(self, name):
        return _Span(self, name)

    def count(self, name, value=1):
        if self.active:
            c = self.counters[name]
            while len(c) <= self.unit:
                c.append(0)
            c[self.unit] += value

    def call(self, kernel, record):
        if self.active:
            self.calls[kernel].append(record)

    def span_sums(self, name):
        """The seconds of spans called `name`, summed per unit."""
        out = defaultdict(float)
        for n, t0, t1, u in self.spans:
            if n == name:
                out[u] += (t1 - t0) * 1e-9
        return [out[u] for u in range(self.units)]

    def innermost(self, t_ns):
        """The name of the innermost span open at t_ns, or None."""
        best = None
        for n, t0, t1, _ in self.spans:
            if t0 <= t_ns < t1 and (best is None or t0 >= best[1]):
                best = (n, t0)
        return best[0] if best else None


class _Span:
    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.rec.active:
            self.rec.spans.append((self.name, self.t0, time.time_ns(), self.rec.unit))
        return False


class DeviceTrace:
    """A torch.profiler session of CUDA activity over the window, and
    what it holds once stopped: every device event's (name, start_ns,
    end_ns), the busy seconds (the union of the events' intervals) and
    the window's length."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.events = []

    def start(self):
        self.torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.time_ns()

    def stop(self):
        self.torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.stop()
        dev = self.torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == dev and e.duration_ns() > 0:
                s = e.start_ns()
                self.events.append((e.name(), s, s + e.duration_ns()))
        self.events.sort(key=lambda e: e[1])

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-9

    def intervals(self):
        """The union of the device events' intervals, clipped to the window."""
        out = []
        for _, s, e in self.events:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self):
        return sum(e - s for s, e in self.intervals()) * 1e-9

    def kernel_s(self, *names):
        """Device seconds of the events whose name contains one of `names`."""
        return sum(e - s for n, s, e in self.events if any(k in n for k in names)) * 1e-9

    def breakdown(self, rec, top=10):
        """The device ops that took most time, by name, and the longest idle
        gaps, each named by the benchmark's innermost spans at its start and
        at its end ("a -> b" where they differ)."""
        by_name = defaultdict(int)
        for n, s, e in self.events:
            by_name[n[:120]] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = [], self.t0
        for s, e in self.intervals() + [[self.t1, self.t1]]:
            if s > prev:
                gaps.append((s - prev, prev, s))
            prev = max(prev, e)
        gaps.sort(reverse=True)
        named = []
        for d, s, e in gaps[:top]:
            a, b = (rec.innermost(t) or "outside the benchmark's spans" for t in (s, e - 1))
            named.append([a if a == b else f"{a} -> {b}", d * 1e-9])
        return {"device_ops": [[n, ns * 1e-9] for n, ns in ops], "idle_gaps": named}
