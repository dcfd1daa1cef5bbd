"""The program's spans and counters (openmvg_torch/utils/logging.py) and
where the bundle adjuster places them (openmvg_torch/sfm/ba.py), on the
CPU: nothing is kept without a profiler session; under one, a solve
records its tree of spans with parents and time.time_ns() stamps, the
counters agree with what the solver returns and with an independent
count of its reads, and the solve's numbers are the same bit for bit.
Then the benchmark's readers of these records (benchmark/metrics/*.ba.py
through benchmark/program_trace.py) on hand-built spans and a synthetic
device trace.
"""

import logging
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.drivers import ba_solve
from benchmark.gen import bal
from benchmark.trace import DeviceTrace
from openmvg_torch.models import cameras as cm
from openmvg_torch.ops import smatvec as k3
from openmvg_torch.sfm import ba
from openmvg_torch.utils import logging as omt
from openmvg_torch.utils.logging import Span

LM_CHILDREN = ["ba.cost", "ba.jacobians", "ba.schur", "ba.cg", "ba.backsub", "ba.cost"]


@pytest.fixture(autouse=True)
def _clean_records():
    omt.clear_records()
    yield
    omt.clear_records()


def _cpu_session():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _problem(kind=cm.PINHOLE_RADIAL_K3):
    """A small BAL-like float64 problem (the benchmark's generator and
    layout): camera model 3 takes the polynomial closed form, PINHOLE (f
    free) its own."""
    prob = bal.make_problem(None, 12, 240, 1300, problem_seed=3)
    p = ba_solve.program_problem(prob, dict(camera_model=cm.PINHOLE_RADIAL_K3,
                                            image_wh=[2000, 2000], dtype="float64"), "cpu")
    if kind == cm.PINHOLE:
        mask = torch.zeros_like(p.mask_intr)
        mask[:, 0] = 1.0
        p = p._replace(intr_kind=torch.full_like(p.intr_kind, cm.PINHOLE), mask_intr=mask)
    return p


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


def test_nothing_is_kept_without_a_profiler_session():
    assert not torch.autograd._profiler_enabled()
    p = _problem()
    ba.adjust(p, ba.BAConfig(max_iterations=2))
    with omt.stage("a_stage"):
        omt.count("a_counter", 3)
        assert omt.host_read(torch.tensor(2.5)) == 2.5
    assert omt.records() == {"spans": [], "counters": {}}
    # one shared object off: no allocation a call
    assert omt.span("x") is omt.span("y", device=True)
    assert "a_stage" in omt.stage_times


def test_a_solve_records_its_tree_with_parents_and_host_stamps():
    p = _problem()
    t_before = time.time_ns()
    with _cpu_session():
        ba.adjust(p, ba.BAConfig(max_iterations=3))
    t_after = time.time_ns()
    spans = omt.records()["spans"]
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["ba.adjust"]
    adj = roots[0]
    kids = _children(spans, adj)
    assert kids[:3] == ["host_read", "ba.plans", "host_read"]
    steps = [i for i, s in enumerate(spans) if s.name == "ba.lm_step"]
    assert steps and set(kids) == {"host_read", "ba.plans", "ba.lm_step"}
    # after each step: its cost, accept and damping read
    assert kids[3:] == ["ba.lm_step", "host_read", "host_read", "host_read"] * len(steps)
    for i in steps:
        assert spans[i].parent == adj
        assert _children(spans, i) == LM_CHILDREN
    for i, s in enumerate(spans):
        assert t_before <= s.t0_ns <= s.t1_ns <= t_after
        assert s.device_s is None                       # off the card
        if s.parent is not None:
            par = spans[s.parent]
            assert s.parent < i and par.t0_ns <= s.t0_ns <= s.t1_ns <= par.t1_ns
        if s.name == "ba.cg":
            assert set(_children(spans, i)) <= {"host_read"} and _children(spans, i)
        if s.name in ("host_read", "ba.plans", "ba.cost", "ba.jacobians", "ba.backsub"):
            assert not _children(spans, i)


def test_cg_iterations_counter_at_zero_tolerance():
    cfg = ba.BAConfig(max_iterations=3, cg_iterations=5, cg_tol=0.0)
    with _cpu_session():
        ba.adjust(_problem(), cfg)
    r = omt.records()
    steps = sum(s.name == "ba.lm_step" for s in r["spans"])
    assert steps == 3
    assert r["counters"]["ba.cg_iterations"] == cfg.cg_iterations * steps


@pytest.mark.parametrize("kind", [cm.PINHOLE_RADIAL_K3, cm.PINHOLE])
def test_host_read_spans_equal_an_independent_count_of_the_reads(kind, monkeypatch):
    """Every read of a tensor's value made from sfm/ba.py, directly or
    through host_read, counted by wrapping Tensor's reading methods; each
    is one host_read span."""
    reads = [0]
    ba_file = ba.__file__

    def counting(orig):
        def wrapper(self, *a, **kw):
            f = sys._getframe(1)
            if f.f_code.co_filename == ba_file or f.f_code.co_name == "host_read":
                reads[0] += 1
            return orig(self, *a, **kw)
        return wrapper

    for name in ("item", "__bool__", "__float__", "__int__", "tolist", "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, counting(getattr(torch.Tensor, name)))
    p = _problem(kind)
    with _cpu_session():
        ba.adjust(p, ba.BAConfig(max_iterations=4))
    spans = omt.records()["spans"]
    assert reads[0] == sum(s.name == "host_read" for s in spans) > 0
    monkeypatch.undo()
    # and the program's reader counts them a solve
    assert harness.reader("host_reads.ba")({}) == reads[0]


@pytest.mark.parametrize("with_plan", [False, True])
def test_k3_counter_counts_the_iterations_k3_ran(with_plan, monkeypatch):
    """ba.cg_k3 counts the CG iterations whose matvec ran in K3: all of
    them where the problem carries K3's plan (put on it here, on the CPU,
    where K3 is its plain version), none where it does not; k3_share.ba
    reads 100 or 0, and nothing from a program that does not count it."""
    prob = bal.make_problem(None, 12, 240, 1300, problem_seed=3)
    p = ba_solve.program_problem(prob, dict(camera_model=cm.PINHOLE_RADIAL_K3,
                                            image_wh=[2000, 2000], dtype="float32"), "cpu")
    if with_plan:
        t = p.pt_obs
        p = p._replace(k3_plan=k3.smatvec_plan(p.obs_pose, p.obs_intr, t.row_point,
                                               p.X.shape[0], p.rotvec.shape[0],
                                               p.intr_params.shape[0]))
    with _cpu_session():
        ba.adjust(p, ba.BAConfig(max_iterations=3))
    c = omt.records()["counters"]
    assert c["ba.cg_iterations"] > 0
    assert c["ba.cg_k3"] == (c["ba.cg_iterations"] if with_plan else 0)
    read = harness.reader("k3_share.ba")
    assert read({}) == (100.0 if with_plan else 0.0)
    older = {"spans": omt.records()["spans"],
             "counters": {k: v for k, v in c.items() if k != "ba.cg_k3"}}
    monkeypatch.setattr(omt, "records", lambda: older)
    assert read({}) is None


def test_accepted_counter_equals_the_solve_s_count():
    with _cpu_session():
        _, _, n_acc = ba.adjust(_problem(), ba.BAConfig(max_iterations=6))
    r = omt.records()
    assert n_acc > 0 and r["counters"]["ba.lm_accepted"] == n_acc


@pytest.mark.parametrize("rows", [None, 40])
def test_jac_chunks_counts_the_chunks_of_each_step(rows):
    """ba.jac_chunks: one a step for a pass, ceil(O / jac_slots) a step for
    a problem whose Jacobians are chunked (forced here; on the card
    with_plans sets jac_slots from the free memory)."""
    p = _problem()
    O = p.obs_pose.shape[0]
    step = None if rows is None else rows * (O // p.pt_obs.row_point.shape[0])
    with _cpu_session():
        ba.adjust(p._replace(jac_slots=step), ba.BAConfig(max_iterations=3))
    r = omt.records()
    steps = sum(s.name == "ba.lm_step" for s in r["spans"])
    assert steps == 3
    assert r["counters"]["ba.jac_chunks"] == steps * (1 if step is None else -(-O // step))
    assert step is None or O % step


def test_jac_chunks_add_up_over_solves_and_nothing_without_a_session():
    """ba.jac_chunks: one a step of each solve in a profiler session, added
    over the solves; nothing recorded with no session."""
    p = _problem()
    ba.adjust(p, ba.BAConfig(max_iterations=2))
    assert omt.records()["counters"] == {}
    with _cpu_session():
        for _ in range(3):
            ba.adjust(p, ba.BAConfig(max_iterations=2))
    r = omt.records()
    assert r["counters"]["ba.jac_chunks"] == sum(s.name == "ba.lm_step" for s in r["spans"])
    assert r["counters"]["ba.jac_chunks"] == 6


@pytest.mark.parametrize("kind", [cm.PINHOLE_RADIAL_K3, cm.PINHOLE])
def test_a_solve_is_bit_identical_traced_and_untraced(kind):
    cfg = ba.BAConfig(max_iterations=5)
    p_off, c_off, n_off = ba.adjust(_problem(kind), cfg)
    with _cpu_session():
        p_on, c_on, n_on = ba.adjust(_problem(kind), cfg)
    assert omt.records()["spans"]
    assert (c_on, n_on) == (c_off, n_off)
    for f in ("rotvec", "t", "intr_params", "X"):
        assert torch.equal(getattr(p_on, f), getattr(p_off, f)), f


def test_stage_is_a_span_and_stop_profiler_logs_and_clears(tmp_path, caplog):
    omt.reset_stage_times()
    omt.start_profiler(str(tmp_path))
    with omt.stage("outer"):
        with omt.span("inner"):
            omt.count("ba.cg_iterations", 7)
            omt.count("ba.cg_iterations", 2)
    spans = omt.records()["spans"]
    assert [(s.name, s.parent) for s in spans] == [("outer", None), ("inner", 0)]
    assert omt.stage_times["outer"] > 0
    with caplog.at_level(logging.INFO, logger="openmvg_torch"):
        path = omt.stop_profiler()
    assert "profile counters: ba.cg_iterations=9" in caplog.text
    assert omt.records() == {"spans": [], "counters": {}}
    with open(path) as f:
        trace = f.read()
    assert '"outer"' in trace and '"inner"' in trace


def test_records_cannot_be_cleared_inside_an_open_span():
    with _cpu_session():
        with omt.span("open"):
            with pytest.raises(RuntimeError, match="open"):
                omt.clear_records()
    assert [s.name for s in omt.records()["spans"]] == ["open"]


# ---------------------------------------------------------------------------
# the benchmark's readers of the records
# ---------------------------------------------------------------------------

MS = 1_000_000


def _hand_built():
    """Two solves of 100 ms.  The first: two LM steps (one accepted), 12 CG
    iterations, 7 reads in it and one read outside any solve; the second:
    one step, accepted, 5 iterations, 2 reads.  Device seconds on the
    phases."""
    S = []

    def add(name, t0, t1, parent, dev=None):
        S.append(Span(name, round(t0 * MS), round(t1 * MS), parent, dev))
        return len(S) - 1

    a = add("ba.adjust", 0.5, 100, None)
    add("host_read", 1, 2, a)
    s1 = add("ba.lm_step", 2, 40, a, 0.036)
    add("ba.jacobians", 3, 20, s1, 0.015)
    c = add("ba.cg", 20, 38, s1, 0.017)
    for k in range(3):
        add("host_read", 21 + 5 * k, 22 + 5 * k, c)
    add("host_read", 40, 41, a)
    s2 = add("ba.lm_step", 41, 99, a, 0.055)
    add("ba.jacobians", 42, 60, s2, 0.017)
    c = add("ba.cg", 60, 97, s2, 0.035)
    add("host_read", 61, 62, c)
    add("host_read", 97, 98, a)
    add("host_read", 105, 106, None)                   # outside the solves
    b = add("ba.adjust", 110, 210, None)
    s3 = add("ba.lm_step", 110, 200, b, 0.089)
    add("ba.jacobians", 111, 150, s3, 0.038)
    c = add("ba.cg", 150, 199, s3, 0.048)
    add("host_read", 151, 152, c)
    add("host_read", 200, 201, b)
    return {"spans": S, "counters": {"ba.cg_iterations": 17, "ba.cg_k3": 12,
                                     "ba.lm_accepted": 2, "ba.jac_chunks": 6,
                                     "ba.jac_closed": 4}}


def _trace(busy_ms):
    """A DeviceTrace over the window [0, 220] ms holding one event a busy
    interval (ms)."""
    tr = DeviceTrace.__new__(DeviceTrace)
    tr.t0, tr.t1 = 0, 220 * MS
    tr.events = [("k", round(s * MS), round(e * MS)) for s, e in busy_ms]
    return tr


# idle gaps of the trace below: [0, 1) before the first solve, [1.5, 3) in
# a read, [10, 12) in issue, [21.2, 23) in a CG read, [30, 31) in issue,
# [97.5, 112) from a solve's last read across the stretch between solves
# (it starts in the read), [160, 161) in issue, [200.5, 220) from the
# second solve's last read to the end of the window
BUSY = [(1, 1.5), (3, 10), (12, 21.2), (23, 30), (31, 97.5), (112, 160), (161, 200.5)]


@pytest.mark.parametrize("name,value", [
    ("cg_iters.ba", 17 / 2),
    ("host_reads.ba", 9 / 2),
    ("lm_accept.ba", 100.0 * 2 / 3),
    ("jac_s.ba", (0.015 + 0.017 + 0.038) / 2),
    ("cg_s.ba", (0.017 + 0.035 + 0.048) / 2),
    ("idle_read.ba", 100.0 * (1.5 + 1.8 + 14.5 + 19.5) / 220),
    ("idle_issue.ba", 100.0 * (2 + 1 + 1) / 220),
    ("k3_share.ba", 100.0 * 12 / 17),
    ("jac_closed.ba", 100.0 * 4 / 6),
])
def test_each_reader_on_hand_built_spans(name, value, monkeypatch):
    monkeypatch.setattr(omt, "records", _hand_built)
    got = harness.reader(name)({"trace": _trace(BUSY)})
    assert got == pytest.approx(value, rel=1e-12)


def test_idle_shares_and_the_idle_outside_the_solves_sum_to_device_idle(monkeypatch):
    from benchmark import program_trace

    monkeypatch.setattr(omt, "records", _hand_built)
    ctx = {"trace": _trace(BUSY)}
    parts = [harness.reader("idle_read.ba")(ctx), harness.reader("idle_issue.ba")(ctx),
             program_trace.idle_share(ctx, None, excluding="ba.adjust")]
    assert parts[2] == pytest.approx(100.0 / 220)      # the gap [0, 1)
    assert sum(parts) == pytest.approx(harness.reader("device_idle.ba")(ctx), rel=1e-12)


def test_k3_roofline_reads_the_bound_of_each_counted_call_over_k3_s_device_time(monkeypatch):
    """k3_roofline.ba: bounds.smatvec_bound_ms at the problem's layout, once
    a call counted in ba.cg_k3 (12), over the summed device time of K3's
    two launches (other kernels left out)."""
    from types import SimpleNamespace

    from benchmark import bounds

    monkeypatch.setattr(omt, "records", _hand_built)
    prob = bal.make_problem(None, 12, 240, 1300, problem_seed=3)
    p = ba_solve.program_problem(prob, dict(camera_model=cm.PINHOLE_RADIAL_K3,
                                            image_wh=[2000, 2000], dtype="float32"), "cpu")
    tr = _trace(BUSY)
    tr.events = [("smatvec_tiles(TileArgs)", 0, 3 * MS), ("camera_sums_kernel", 3 * MS, 9 * MS),
                 ("void smatvec_camera_sums(float const*)", 10 * MS, 15 * MS)]
    t = p.pt_obs
    bound_ms = bounds.smatvec_bound_ms(p.obs_pose.shape[0], t.row_point.shape[0],
                                       *t.groups.shape, 12, p.intr_params.shape[0])
    read, ctx = harness.reader("k3_roofline.ba"), {"trace": tr, "state": SimpleNamespace(p0=p)}
    assert read(ctx) == pytest.approx(100.0 * 12 * bound_ms / 8.0, rel=1e-12)
    older = {"spans": _hand_built()["spans"], "counters": {"ba.cg_iterations": 17}}
    monkeypatch.setattr(omt, "records", lambda: older)
    assert read(ctx) is None                           # a program without ba.cg_k3
    monkeypatch.setattr(omt, "records", _hand_built)
    tr.events = tr.events[1:2]
    assert read(ctx) is None                           # K3 did not launch


def test_k3_roofline_final_reads_the_bound_without_a_table(monkeypatch):
    """k3_roofline.final: bounds.smatvec_bound_ms at the problem's layout
    with a table of width 0 (K3 reads none), once a call counted in
    ba.cg_k3 (12), over the device time of K3's two launches; it reads the
    problem without a group table that k3_roofline.ba leaves out."""
    from types import SimpleNamespace

    from benchmark import bounds

    monkeypatch.setattr(omt, "records", _hand_built)
    p = _problem()
    p = p._replace(pt_obs=p.pt_obs._replace(groups=None))
    tr = _trace(BUSY)
    tr.events = [("smatvec_tiles(TileArgs)", 0, 3 * MS), ("camera_sums_kernel", 3 * MS, 9 * MS),
                 ("void smatvec_camera_sums(float const*)", 10 * MS, 15 * MS)]
    bound_ms = bounds.smatvec_bound_ms(p.obs_pose.shape[0], p.pt_obs.row_point.shape[0],
                                       p.X.shape[0], 0, 12, p.intr_params.shape[0])
    ctx = {"trace": tr, "state": SimpleNamespace(p0=p)}
    got = harness.reader("k3_roofline.final")(ctx)
    assert got == pytest.approx(100.0 * 12 * bound_ms / 8.0, rel=1e-12)
    assert harness.reader("k3_roofline.ba")(ctx) is None


@pytest.mark.parametrize("kind,share", [(cm.PINHOLE_RADIAL_K3, 100.0), (cm.PINHOLE, 100.0),
                                        (cm.PINHOLE_FISHEYE, 0.0)])
def test_jac_closed_reads_the_closed_form_s_share_of_a_solve_s_chunks(kind, share,
                                                                       monkeypatch):
    """jac_closed.ba after real solves: 100% on the closed forms, 0% on
    forward mode; None for a program that counts ba.jac_chunks but not
    ba.jac_closed."""
    p = _problem(kind if kind != cm.PINHOLE_FISHEYE else cm.PINHOLE_RADIAL_K3)
    if kind == cm.PINHOLE_FISHEYE:
        p = p._replace(intr_kind=torch.full_like(p.intr_kind, kind))
    with _cpu_session():
        ba.adjust(p, ba.BAConfig(max_iterations=2))
    read = harness.reader("jac_closed.ba")
    assert read({}) == share
    c = omt.records()["counters"]
    older = {"spans": omt.records()["spans"],
             "counters": {k: v for k, v in c.items() if k != "ba.jac_closed"}}
    monkeypatch.setattr(omt, "records", lambda: older)
    assert read({}) is None


def test_peak_mem_final_reads_the_allocators_peak_over_the_card():
    """peak_mem.final: the allocator's peak over the window (the harness
    resets it as the window starts), as a share of the card's total
    memory; None off the card."""
    from types import SimpleNamespace

    card = SimpleNamespace(cuda=SimpleNamespace(
        max_memory_allocated=lambda: 20 * 2 ** 30,
        get_device_properties=lambda i: SimpleNamespace(total_memory=80 * 2 ** 30)))
    read = harness.reader("peak_mem.final")
    assert read({"trace": _trace(BUSY), "torch": card}) == pytest.approx(25.0, rel=1e-12)
    assert read({"trace": None, "torch": card}) is None          # off the card
    assert read({"trace": _trace(BUSY)}) is None                  # no torch given


@pytest.mark.parametrize("name", ["cg_iters.ba", "host_reads.ba", "lm_accept.ba", "jac_s.ba",
                                  "cg_s.ba", "idle_read.ba", "idle_issue.ba",
                                  "k3_share.ba", "k3_roofline.ba", "k3_roofline.final",
                                  "peak_mem.final", "jac_closed.ba"])
def test_each_reader_gives_none_where_nothing_was_recorded(name, monkeypatch):
    read = harness.reader(name)
    assert read({"trace": _trace(BUSY)}) is None      # no records
    monkeypatch.setattr(omt, "records", _hand_built)
    if name.startswith("idle_"):
        assert read({"trace": None}) is None          # off the card
    elif name in ("jac_s.ba", "cg_s.ba"):
        cpu = lambda: {"spans": [s._replace(device_s=None) for s in _hand_built()["spans"]],
                       "counters": {}}
        monkeypatch.setattr(omt, "records", cpu)
        assert read({"trace": None}) is None          # spans without device times
    monkeypatch.delattr(omt, "records")
    assert read({"trace": _trace(BUSY)}) is None      # a program without records
