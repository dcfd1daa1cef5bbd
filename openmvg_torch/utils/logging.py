"""Logging, timers, progress, profiling, and the program's spans and
counters (counterpart: openmvg_tpu/utils/logging.py; system/logger.hpp,
system/timer.hpp, system/loggerprogress.hpp).

`with stage("ba_solve"):` adds the block's seconds to stage_times under
that name, summed over re-entries.  When CUDA is initialised, the device
is synchronised as a timer ends, so the seconds include the device work
the block queued and not only its launches.  A stage is also a span.

Spans and counters record exactly while a torch.profiler session records
(torch.autograd._profiler_enabled(): the CLI's --profile DIR or
OMT_PROFILE_DIR, or a session the caller opens).  `with span(name):`
keeps (name, t0_ns, t1_ns, parent) in memory, stamped with
time.time_ns(), the clock of the profiler's device events, its parent
the innermost open span; it also opens torch.profiler.record_function(
name), so the program's spans appear in --profile's Chrome trace.  With
device=True on the card it records a CUDA event on the current stream at
entry and at exit, without synchronising; records() resolves the device
seconds between them.  count(name, n) adds to a counter, and
host_read(t) is t.item() inside a span named host_read.  With no session
recording, each call costs one check and keeps nothing.  The records are
the process's, for one thread; stop_profiler logs the counters and
clears them.
"""

import contextlib
import logging
import os
import sys
import time
from typing import NamedTuple, Optional

import torch

logger = logging.getLogger("openmvg_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[%(levelname)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

log_info = logger.info

stage_times = {}


class Timer:
    """Wall timer; `with Timer("name", log=True) as t:` logs t.elapsed on
    exit, after the device has finished the block's work."""

    def __init__(self, name=None, log=False):
        self.name = name
        self.log = log
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - self.t0
        if self.log and self.name:
            log_info(f"{self.name}: {self.elapsed:.3f}s")
        return False


class Progress:
    """LoggerProgress: update() per item, a log line at every 10%."""

    def __init__(self, total, name=""):
        self.total = max(total, 1)
        self.name = name
        self.count = 0
        self._next = 0.1

    def update(self, n=1):
        self.count += n
        frac = self.count / self.total
        if frac >= self._next:
            log_info(f"{self.name}: {int(frac * 100)}% ({self.count}/{self.total})")
            while self._next <= frac:
                self._next += 0.1


class stage(Timer):
    """A Timer that records into stage_times and is a span of the same
    name (stamped at entry and after the exit's synchronisation)."""

    def __init__(self, name):
        super().__init__(name)
        self._span = None

    def __enter__(self):
        self._span = span(self.name)
        self._span.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._span.__exit__(*exc)
        self._span = None
        stage_times[self.name] = stage_times.get(self.name, 0.0) + self.elapsed
        return out


def reset_stage_times():
    stage_times.clear()


def format_stage_times(times=None):
    """One line per stage, in the order the stages first ran."""
    times = stage_times if times is None else times
    return "\n".join(f"  {k:<18s} {v:9.3f} s" for k, v in times.items())


_session = None


def start_profiler(logdir):
    """Start a torch.profiler session (CPU activity, and CUDA activity when
    a card is present) that stop_profiler writes into logdir."""
    global _session
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _session = (torch.profiler.profile(activities=acts), logdir)
    _session[0].start()
    log_info(f"torch profiler trace -> {logdir}")


def stop_profiler():
    """Stop the session and write its Chrome trace,
    logdir/omt_trace_<pid>.json (chrome://tracing or Perfetto), which
    holds the program's spans; log the session's counters in one line
    and clear the records; returns the trace's path."""
    global _session
    prof, logdir = _session
    _session = None
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(logdir, f"omt_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    log_info("profile counters: " + (" ".join(f"{k}={v}" for k, v in sorted(_counters.items()))
                                     or "none"))
    clear_records()
    return path


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

class Span(NamedTuple):
    """One span of records(): its name, host stamps (time.time_ns(); t1_ns
    None while it is open), the index of its parent in the list (None at
    a root), and its device-timeline seconds, from the stream reaching
    its entry to finishing the work it queued (None unless device=True on
    the card)."""

    name: str
    t0_ns: int
    t1_ns: Optional[int]
    parent: Optional[int]
    device_s: Optional[float]


_spans = []     # [name, t0_ns, t1_ns, parent, (entry, exit CUDA events) or None, device_s]
_open = []      # indices into _spans of the open spans, innermost last
_counters = {}
_OFF = contextlib.nullcontext()   # what span() returns while nothing records


class _Span:
    __slots__ = ("rec", "range")

    def __init__(self, name, device):
        self.range = torch.profiler.record_function(name)
        events = None
        if device and torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        self.rec = [name, None, None, None, events, None]

    def __enter__(self):
        self.range.__enter__()
        self.rec[3] = _open[-1] if _open else None
        _open.append(len(_spans))
        _spans.append(self.rec)
        self.rec[1] = time.time_ns()
        if self.rec[4] is not None:
            self.rec[4][0].record()
        return self

    def __exit__(self, *exc):
        if self.rec[4] is not None:
            self.rec[4][1].record()
        self.rec[2] = time.time_ns()
        _open.pop()
        self.range.__exit__(*exc)
        return False


def span(name, device=False):
    """Context manager: a span called `name` while a profiler session
    records (see the module docstring), nothing otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, device)


def count(name, n=1):
    """Add n to the counter `name` while a profiler session records."""
    if torch.autograd._profiler_enabled():
        _counters[name] = _counters.get(name, 0) + n


def host_read(t):
    """t.item(), the host waiting on the device, inside a span named
    host_read."""
    with span("host_read"):
        return t.item()


def records():
    """{"spans": [Span, ...] in the order they opened (a parent before its
    children), "counters": {name: total}}, kept since clear_records().  A
    closed device span's seconds are resolved here, once, waiting for its
    exit event."""
    for rec in _spans:
        if rec[4] is not None and rec[2] is not None:
            rec[4][1].synchronize()
            rec[5] = rec[4][0].elapsed_time(rec[4][1]) * 1e-3
            rec[4] = None
    return {"spans": [Span(*rec[:4], rec[5]) for rec in _spans],
            "counters": dict(_counters)}


def clear_records():
    """Forget every span and counter (no span may be open)."""
    if _open:
        raise RuntimeError(f"clear_records() inside the open span {_spans[_open[-1]][0]!r}")
    _spans.clear()
    _counters.clear()
