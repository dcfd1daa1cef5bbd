"""Logging, timers, progress and profiling (counterpart:
openmvg_tpu/utils/logging.py; system/logger.hpp, system/timer.hpp,
system/loggerprogress.hpp).

`with stage("ba_solve"):` adds the block's seconds to stage_times under
that name, summed over re-entries.  When CUDA is initialised, the device
is synchronised as a timer ends, so the seconds include the device work
the block queued and not only its launches.  While a torch.profiler
session is recording (the CLI's --profile DIR or OMT_PROFILE_DIR), a
stage is also a named range in the trace.
"""

import logging
import os
import sys
import time

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
    """A Timer that records into stage_times and, while a profiler session
    records, opens torch.profiler.record_function(name)."""

    def __init__(self, name):
        super().__init__(name)
        self._range = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
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
    logdir/omt_trace_<pid>.json (chrome://tracing or Perfetto); returns
    the trace's path."""
    global _session
    prof, logdir = _session
    _session = None
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(logdir, f"omt_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path
