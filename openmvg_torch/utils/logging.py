"""Per-stage wall-clock timers (counterpart: openmvg_tpu/utils/logging.py,
`stage` and its table).

`with stage("ba_solve"):` adds the block's seconds to stage_times under
that name, summed over re-entries.  When CUDA is initialised, the device
is synchronised as a stage ends, so the seconds include the device work
the stage queued and not only its launches; the stage also shows as a
named range in a torch.profiler trace.
"""

import time

import torch

stage_times = {}


class stage:
    def __init__(self, name):
        self.name = name
        self.elapsed = 0.0
        self._range = None

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - self.t0
        self._range.__exit__(*exc)
        stage_times[self.name] = stage_times.get(self.name, 0.0) + self.elapsed
        return False


def reset_stage_times():
    stage_times.clear()


def format_stage_times(times=None):
    """One line per stage, in the order the stages first ran."""
    times = stage_times if times is None else times
    return "\n".join(f"  {k:<18s} {v:9.3f} s" for k, v in times.items())
