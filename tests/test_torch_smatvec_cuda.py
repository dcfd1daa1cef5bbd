"""Kernel K3 on the card: openmvg_torch/csrc/smatvec.cu against its plain
PyTorch version (openmvg_torch/ops/smatvec.py).  The kernel has no CPU
build, so every test here needs an NVIDIA card and nvcc and skips without
them.  On a machine with a card (which need not have JAX; the repo's
conftest imports it, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_smatvec_cuda.py -q

The reference is the plain version on the same inputs in float64.  The
kernel's float32 rounding scales with the magnitudes behind each output
(smatvec_magnitudes, S), not with the output, which cancels, so it is held
to 1e-5 (1 + S); the e buffer its first launch writes is held the same way
against smatvec_e_plain.  Two calls on one input must be bitwise equal (the
kernel uses no float atomics), and a call is two launches.
"""

import numpy as np
import pytest
import torch

from openmvg_torch.ops import seg_sum as k2
from openmvg_torch.ops import smatvec as k3

pytestmark = pytest.mark.cuda

# name, poses, intrinsics, slots a row, points, most observations a point,
# kind: "one" = one point holds every observation, "hub" = point L // 2
# holds HUB_OBS of them (more than one tile of the kernel's first launch)
CASES = [
    ("P1_I1_R4", 1, 1, 4, 3000, 6, None),
    ("P100_I1_R8_multirow", 100, 1, 8, 20000, 40, None),
    ("P100_I8_R16", 100, 8, 16, 8000, 50, None),
    ("P1500_I8_R32", 1500, 8, 32, 20000, 70, None),
    ("P100_I1_R4_one_point_holds_all", 100, 1, 4, 1, 40000, "one"),
    ("P7_I2_R8_tracks_1_40_across_tiles", 7, 2, 8, 3000, 40, None),
    ("P5_I1_R32_one_point_over_a_tile", 5, 1, 32, 1, 1500, "one"),
    ("P30_I2_R8_hub_among_tracks", 30, 2, 8, 2000, 12, "hub"),
]
HUB_OBS = 5000


def k3_case(P, I, R, L, max_obs, kind, seed):
    """A point-major layout: point l has 1..max_obs observations in
    ceil(n / R) rows of R slots; the slack slots carry zero Jacobians and
    pose 0 as sfm/ba.py::point_major_layout lays them out; group entries
    past a point's rows are the sentinel L1; pose P // 2 has no
    observation when P > 1 (and its output must be zero)."""
    rng = np.random.default_rng(seed)
    n = np.full(L, max_obs) if kind == "one" else rng.integers(1, max_obs + 1, L)
    if kind == "hub":
        n[L // 2] = HUB_OBS
    nrow = -(-n // R)
    L1, M = int(nrow.sum()), int(nrow.max())
    start = np.concatenate([[0], np.cumsum(nrow)[:-1]])
    row_point = np.repeat(np.arange(L), nrow).astype(np.int32)
    col = np.arange(M)[None, :]
    groups = np.where(col < nrow[:, None], start[:, None] + col, L1).astype(np.int32)
    O = L1 * R
    slot = np.arange(O)
    used = (slot % R) < (n[row_point[slot // R]] - R * (slot // R - start[row_point[slot // R]]))
    pose = rng.integers(0, P, O)
    if P > 1:
        pose[pose == P // 2] = (P // 2 + 1) % P
    pose[~used] = 0
    intr = np.where(used, rng.integers(0, I, O), 0)
    jp = rng.normal(size=(O, 2, 6)).astype(np.float32) * used[:, None, None]
    ji = rng.normal(size=(O, 2, 8)).astype(np.float32) * used[:, None, None]
    jx = rng.normal(size=(O, 2, 3)).astype(np.float32) * used[:, None, None]
    A = rng.normal(size=(L, 3, 3))
    hinv = np.linalg.inv(np.einsum("lij,lkj->lik", A, A) + 3 * np.eye(3)).astype(np.float32)
    return (jp, ji, jx, pose.astype(np.int32), intr.astype(np.int32),
            rng.normal(size=(P, 6)).astype(np.float32),
            rng.normal(size=(I, 8)).astype(np.float32), hinv, row_point, groups)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel K3 runs only there")
    k3.build()
    k2.build()
    return torch.device("cuda")


@pytest.mark.parametrize("name,P,I,R,L,max_obs,kind", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain_and_repeats(dev, name, P, I, R, L, max_obs, kind):
    args = [torch.as_tensor(a, device=dev) for a in k3_case(P, I, R, L, max_obs, kind, P + R)]
    plan = k3.smatvec_plan(args[3], args[4], args[8], L, P, I)
    before = k3.LAUNCHES
    got = k3.smatvec(*args)
    again = k3.smatvec(*args, plan=plan)
    torch.cuda.synchronize()
    assert k3.LAUNCHES == before + 4
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    d = [a.double().cpu() if a.is_floating_point() else a.cpu() for a in args]
    ref = k3.smatvec_plain(*d)
    mag = k3.smatvec_magnitudes(*d)
    for g, r, s in zip(got, ref, mag):
        assert bool(torch.isfinite(g).all())
        assert bool(((g.double().cpu() - r).abs() <= 1e-5 * (1 + s)).all())
    e_ref, e_mag = k3.smatvec_e_plain(*d), k3.smatvec_e_magnitudes(*d)
    assert bool(((plan.e.double().cpu() - e_ref).abs() <= 1e-5 * (1 + e_mag)).all())
    if P > 1:
        assert bool((got[0][P // 2] == 0).all())       # the pose without observations


@pytest.mark.parametrize("name,P,I,R,L,max_obs,kind", CASES[:4] + CASES[6:],
                         ids=[c[0] for c in CASES[:4] + CASES[6:]])
def test_kernel_without_a_group_table_matches_plain(dev, name, P, I, R, L, max_obs, kind):
    """K3 planned from row_point alone (no group table anywhere, as at a
    problem over build_pt_obs's table budget): within 1e-5 (1 + S) of the
    plain version, which folds the rows through row_point, in float64;
    two calls bitwise equal."""
    args = [torch.as_tensor(a, device=dev) for a in k3_case(P, I, R, L, max_obs, kind, P + R)]
    args[9] = None
    plan = k3.smatvec_plan(args[3], args[4], args[8], L, P, I)
    got = k3.smatvec(*args, plan=plan)
    again = k3.smatvec(*args, plan=plan)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    d = [None if a is None else a.double().cpu() if a.is_floating_point() else a.cpu()
         for a in args]
    ref = k3.smatvec_plain(*d)
    mag = k3.smatvec_magnitudes(*d)
    for g, r, s in zip(got, ref, mag):
        assert bool(torch.isfinite(g).all())
        assert bool(((g.double().cpu() - r).abs() <= 1e-5 * (1 + s)).all())


def test_wrapper_raises_on_unsupported(dev):
    args = [torch.as_tensor(a, device=dev) for a in k3_case(4, 1, 4, 50, 5, None, 0)]
    with pytest.raises(TypeError):
        k3.smatvec(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        k3.smatvec(*args[:5], args[5][:, :5], *args[6:])
    cpu_plan = k3.smatvec_plan(*[a.cpu() for a in (args[3], args[4], args[8])], 50, 4, 1)
    with pytest.raises(ValueError, match="plan"):
        k3.smatvec(*args, plan=cpu_plan)


def test_kernel_at_the_bal_cell_s_shape_class(dev):
    """K3 at the shape class of the BAL Dubrovnik cell: R = 4, 356 poses
    and 356 intrinsics (each observation's intrinsic its camera's) whose
    Jacobians hold only the f, k1 and k2 columns, points of 1 to 36 rows
    (up to 144 observations), slack slots with zero Jacobians as obs_w = 0
    leaves them.  Within 1e-5 (1 + S) of the plain version in float64, and
    two calls bitwise equal."""
    c = list(k3_case(356, 356, 4, 12000, 144, None, seed=356))
    cols = np.zeros(8, np.float32)
    cols[[0, 3, 4]] = 1.0
    c[1] = c[1] * cols                     # f, k1, k2 of PINHOLE_CAMERA_RADIAL3
    c[4] = c[3].copy()                     # one intrinsic a camera
    args = [torch.as_tensor(a, device=dev) for a in c]
    assert c[9].shape[1] == 36             # the widest point's rows
    plan = k3.smatvec_plan(args[3], args[4], args[8], 12000, 356, 356)
    got = k3.smatvec(*args, plan=plan)
    again = k3.smatvec(*args, plan=plan)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    d = [a.double().cpu() if a.is_floating_point() else a.cpu() for a in args]
    ref = k3.smatvec_plain(*d)
    mag = k3.smatvec_magnitudes(*d)
    for g, r, s in zip(got, ref, mag):
        assert bool(torch.isfinite(g).all())
        assert bool(((g.double().cpu() - r).abs() <= 1e-5 * (1 + s)).all())


def test_adjust_runs_every_cg_iteration_through_k3(dev, monkeypatch):
    """One float32 adjust of a reduced BAL-like problem (the benchmark's
    generator and layout: camera model 3, f, k1, k2 free) on the card,
    with no switch set: K3's plan built once, in ba.plans, two K3 launches
    a CG iteration, ba.cg_k3 equal to ba.cg_iterations, and the final cost
    within 1e-4 relative of the same solve with the gate patched to
    decline the card (the unfused matvec).  with_plans builds no K3 plan
    for the same problem sharded or in float64."""
    from benchmark.drivers import ba_solve
    from benchmark.gen import bal
    from openmvg_torch.models import cameras as cm
    from openmvg_torch.sfm import ba
    from openmvg_torch.utils import logging as omt

    prob = bal.make_problem(None, 36, 6000, 40000, problem_seed=7)
    p = ba_solve.program_problem(prob, dict(camera_model=cm.PINHOLE_RADIAL_K3,
                                            image_wh=[2000, 2000], dtype="float32"), dev)
    cfg = ba.BAConfig(max_iterations=8)
    assert ba.with_plans(p).k3_plan is not None
    assert ba.with_plans(p, group=object()).k3_plan is None
    assert ba.with_plans(p._replace(X=p.X.double())).k3_plan is None
    plans = []
    orig_plan = k3.smatvec_plan

    def plan(*a, **k):
        plans.append(1)
        return orig_plan(*a, **k)

    monkeypatch.setattr(k3, "smatvec_plan", plan)
    omt.clear_records()
    k3.LAUNCHES = 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _, cost, _ = ba.adjust(p, cfg)
    torch.cuda.synchronize()
    counters = omt.records()["counters"]
    omt.clear_records()
    its = counters["ba.cg_iterations"]
    assert its > 0 and counters["ba.cg_k3"] == its
    assert k3.LAUNCHES == 2 * its
    assert len(plans) == 1
    monkeypatch.setattr(ba, "k3_gate", lambda p, group=None: False)
    k3.LAUNCHES = 0
    _, cost_off, _ = ba.adjust(p, cfg)
    assert k3.LAUNCHES == 0
    assert abs(cost - cost_off) <= 1e-4 * abs(cost_off)
