"""The program's spans on the card (openmvg_torch/utils/logging.py, placed
in openmvg_torch/sfm/ba.py): a float32 solve under a profiler session of
CUDA activity only, as the benchmark's traced window opens it.  Needs an
NVIDIA card and nvcc (K2); skips without them.  On a machine with a card:

    python -m pytest --noconftest tests/test_torch_trace_cuda.py -q -s

The session must turn the records on; every device span gets its device
seconds; the LM phases fit inside their step on the device timeline; the
host_read spans hold the device-to-host copies of their reads on the
profiler's device clock: the median read's copy ends within CLOCK_NS
before the read's end (the host's wake-up), so the spans' time.time_ns()
stamps and the device events share a clock (it wanders by up to ~1 ms for
some seconds of some runs, which tools/ba_trace_report.py reports over a
whole window); and the solve's numbers are the same bit for bit traced
and untraced.
"""

import pytest
import torch

from benchmark.drivers import ba_solve
from benchmark.gen import bal
from openmvg_torch.sfm import ba
from openmvg_torch.utils import logging as omt

pytestmark = pytest.mark.cuda

CLOCK_NS = 20_000
PHASES = ("ba.cost", "ba.jacobians", "ba.schur", "ba.cg", "ba.backsub")


@pytest.fixture
def problem():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    prob = bal.make_problem(None, 60, 6000, 33000, problem_seed=5)
    cfg = dict(camera_model=3, image_wh=[2000, 2000], dtype="float32")
    omt.clear_records()
    yield lambda: ba_solve.program_problem(prob, cfg, "cuda")
    omt.clear_records()


def _traced(p, cfg):
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    try:
        assert torch.autograd._profiler_enabled()
        out = ba.adjust(p, cfg)
        torch.cuda.synchronize()
    finally:
        prof.stop()
    return out, prof


def test_a_cuda_only_session_records_device_spans_on_the_profiler_clock(problem):
    cfg = ba.BAConfig(max_iterations=6)
    ba.adjust(problem(), cfg._replace(max_iterations=1))        # warm-up: builds, plans
    omt.clear_records()
    (p_on, c_on, n_on), prof = _traced(problem(), cfg)
    r = omt.records()
    spans = r["spans"]
    assert [s.name for s in spans if s.parent is None] == ["ba.adjust"]
    assert r["counters"]["ba.lm_accepted"] == n_on
    for i, s in enumerate(spans):
        dev = s.name in PHASES + ("ba.lm_step",)
        assert (s.device_s is not None) == dev, s
        if s.name == "ba.lm_step":
            phases = sum(c.device_s for c in spans if c.parent == i)
            assert 0 < phases <= s.device_s * (1 + 1e-6) + 1e-5, (phases, s.device_s)

    ends = sorted(e.start_ns() + e.duration_ns() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA and "DtoH" in e.name())
    lag = sorted(min((s.t1_ns - e for e in ends), key=abs)
                 for s in spans if s.name == "host_read")
    median = lag[len(lag) // 2]
    print(f"\n{len(lag)} host_read spans, {len(ends)} DtoH copies on the device; read end "
          f"less its copy's end: median {median} ns, least {lag[0]}, most {lag[-1]}")
    assert 0 < median <= CLOCK_NS

    p_off, c_off, n_off = ba.adjust(problem(), cfg)
    assert (c_on, n_on) == (c_off, n_off)
    for f in ("rotvec", "t", "intr_params", "X"):
        assert torch.equal(getattr(p_on, f), getattr(p_off, f)), f
