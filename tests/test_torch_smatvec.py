"""Port parity for kernel K3's plain version and the fused branch of the
Schur-CG solve: openmvg_torch/ops/smatvec.py against
openmvg_tpu/ops/pallas_smatvec.py::s_matvec_halves (Pallas in interpret
mode on the CPU), and schur_cg_solve's fused branch (K3's plain version on
the CPU, with K3's plan put on the problem) against the same solve
unfused.

The matvec cases are the problem of tests/test_pallas_smatvec.py (seed 0,
R = 4) and three more seeds and row widths, float32 on both sides, held to
2e-4 as that test holds the reference.  The kernel itself runs only on
the card (tests/test_torch_smatvec_cuda.py).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmvg_tpu.models import cameras as jcm
from openmvg_tpu.ops import pallas_smatvec
from openmvg_torch.ops import smatvec as k3
from openmvg_torch.sfm import ba as tba
from tests.test_torch_ba import _problem, fields_of


def smatvec_case(seed, R, P=5, I=2, L=16, L1=32, max_rows=2):
    """tests/test_pallas_smatvec.py's problem: L points of 1..max_rows
    rows of R slots in an L1-row layout, padding rows (row_point = L) and
    their slots zero, the group table's sentinel at the first padding row."""
    rng = np.random.default_rng(seed)
    nrow = rng.integers(1, max_rows + 1, L)
    assert nrow.sum() <= L1
    row_point = np.full(L1, L, np.int32)
    groups = np.full((L, max_rows), L1, np.int32)
    r = 0
    for pt in range(L):
        for k in range(nrow[pt]):
            row_point[r] = pt
            groups[pt, k] = r
            r += 1
    groups[groups == L1] = r
    O = L1 * R
    obs_pose = rng.integers(0, P, O).astype(np.int32)
    obs_intr = rng.integers(0, I, O).astype(np.int32)
    jp = rng.normal(size=(O, 12)).astype(np.float32)
    ji = rng.normal(size=(O, 16)).astype(np.float32)
    jx = rng.normal(size=(O, 6)).astype(np.float32)
    pad = np.repeat(row_point == L, R)
    jp[pad] = ji[pad] = jx[pad] = 0
    vp = rng.normal(size=(P, 6)).astype(np.float32)
    vi = rng.normal(size=(I, 8)).astype(np.float32)
    A = rng.normal(size=(L, 3, 3)).astype(np.float32)
    hpp_inv = np.linalg.inv(np.einsum("lij,lkj->lik", A, A)
                            + 3 * np.eye(3, dtype=np.float32)).astype(np.float32)
    return dict(jp=jp, ji=ji, jx=jx, pose=obs_pose, intr=obs_intr, vp=vp, vi=vi,
                hpp_inv=hpp_inv, row_point=row_point, groups=groups, R=R)


CASES = [(0, 4), (1, 8), (2, 16), (3, 32)]


@pytest.mark.parametrize("seed,R", CASES)
def test_plain_matches_reference_kernel(seed, R):
    c = smatvec_case(seed, R)
    jpk = pallas_smatvec.pack_slots(*(jnp.asarray(c[k]) for k in ("jp", "ji", "jx", "pose",
                                                                   "intr")))
    tpk = k3.pack_slots(*(torch.as_tensor(c[k]) for k in ("jp", "ji", "jx", "pose", "intr")))
    np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
    rows = pallas_smatvec.plan(tpk.shape[0], R, 5, 2, jnp.float32)
    assert rows is not None
    sp_j, si_j = pallas_smatvec.s_matvec_halves(
        jpk, jnp.asarray(c["vp"]), jnp.asarray(c["vi"]), jnp.asarray(c["hpp_inv"]),
        jnp.asarray(c["row_point"]), jnp.asarray(c["groups"]), R=R, rows=rows,
        interpret=True)
    t = {k: torch.as_tensor(c[k]) for k in ("vp", "vi", "hpp_inv", "row_point", "groups")}
    sp, si = k3.smatvec_plain(*k3.unpack_slots(tpk), t["vp"], t["vi"], t["hpp_inv"],
                              t["row_point"], t["groups"])
    np.testing.assert_allclose(sp.numpy(), np.asarray(sp_j), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(si.numpy(), np.asarray(si_j), rtol=2e-4, atol=2e-4)
    # the CPU wrapper is the plain version, and S bounds every output
    got = k3.smatvec(*k3.unpack_slots(tpk), t["vp"], t["vi"], t["hpp_inv"], t["row_point"],
                     t["groups"])
    assert torch.equal(got[0], sp) and torch.equal(got[1], si)
    S = k3.smatvec_magnitudes(*k3.unpack_slots(tpk), t["vp"], t["vi"], t["hpp_inv"],
                              t["row_point"], t["groups"])
    for out, mag in zip((sp, si), S):
        assert bool((out.abs() <= mag * (1 + 1e-5)).all())


def test_wrapper_refuses_a_broken_layout():
    c = smatvec_case(0, 4)
    t = {k: torch.as_tensor(v) for k, v in c.items() if k != "R"}
    with pytest.raises(ValueError, match="rows"):
        k3.smatvec(t["jp"][:-1], t["ji"][:-1], t["jx"][:-1], t["pose"][:-1], t["intr"][:-1],
                   t["vp"], t["vi"], t["hpp_inv"], t["row_point"], t["groups"])


def _f32_problem():
    jp, _ = _problem(jcm.PINHOLE, (), 4)
    p = tba.problem_from_reference(fields_of(jp), dtype=torch.float32)
    assert p.pt_obs.rows is None and p.pt_obs.groups is not None
    return p


def _solve(p):
    cfg = tba.BAConfig()
    p = tba.with_plans(p)
    fast = tba.cam_fast_ok(p)
    r, Jp6, Ji8, Jx3 = tba.jacobians(p, cfg, fast)
    lam = torch.tensor(1e-4, dtype=p.X.dtype)
    return tba.schur_cg_solve(p, r, Jp6, Ji8, Jx3, lam, cfg)


def with_k3_plan(p):
    """p with K3's plan, as with_plans builds it on the card, so that its
    CG matvec runs through K3's plain version on the CPU."""
    t = p.pt_obs
    return p._replace(k3_plan=k3.smatvec_plan(p.obs_pose, p.obs_intr, t.row_point,
                                              p.X.shape[0], p.rotvec.shape[0],
                                              p.intr_params.shape[0]))


def claims_the_card(p):
    """p whose parameters claim to be float32 on the card, so that k3_gate
    weighs everything else about it."""
    return p._replace(X=types.SimpleNamespace(is_cuda=True, dtype=torch.float32))


def k3_on_the_cpu(monkeypatch):
    """Every ba.adjust whose problem the gate would take on the card gets
    K3's plan first, so that the engines' BAs run through K3's plain
    version on the CPU."""
    orig = tba.adjust

    def adjust(p, *a, **k):
        if (p.k3_plan is None and p.X.dtype == torch.float32
                and tba.k3_gate(claims_the_card(p), k.get("group"))):
            p = with_k3_plan(p)
        return orig(p, *a, **k)

    monkeypatch.setattr(tba, "adjust", adjust)


def test_fused_schur_cg_solve_matches_unfused(monkeypatch):
    """One damped solve of a 6-view float32 problem (poses, intrinsics and
    points free), fused and unfused, both on the CPU, the branch chosen by
    K3's plan on the problem (with_plans builds none on the CPU; the test
    builds it).  The two matvecs sum in other orders, so float32 rounding
    (about 1e-7 relative a step) enters each CG iteration; the updates
    agree to 1e-4 of their largest magnitude and the predicted gains to
    1e-4 relative.  The fused branch must have run once per CG
    iteration."""
    p = _f32_problem()
    calls = []
    orig = k3.smatvec

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(k3, "smatvec", counted)
    ref = _solve(p)
    assert not calls
    got = _solve(with_k3_plan(p))
    assert calls
    for a, b in zip(got[:3], ref[:3]):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale
    assert abs(float(got[3]) - float(ref[3])) <= 1e-4 * abs(float(ref[3]))


def test_fused_gate_declines_what_the_reference_declines():
    """The gate: an unsharded float32 problem on the card, in the
    point-major layout, with a group table or without one (K3 plans from
    the rows' points alone); anything else takes the unfused matvec, and
    with_plans builds no K3 plan for it."""
    p = _f32_problem()
    assert not tba.k3_gate(p)                                            # the CPU
    assert tba.with_plans(p).k3_plan is None
    c = claims_the_card(p)
    assert tba.k3_gate(c)
    f64 = types.SimpleNamespace(is_cuda=True, dtype=torch.float64)
    assert not tba.k3_gate(c._replace(X=f64))                            # float64
    t = p.pt_obs
    rows = torch.arange(p.obs_pose.shape[0]).reshape(t.row_point.shape[0], -1)
    assert not tba.k3_gate(c._replace(pt_obs=t._replace(rows=rows)))     # gather form
    assert tba.k3_gate(c._replace(pt_obs=t._replace(groups=None)))       # no group table
    assert not tba.k3_gate(c._replace(pt_obs=None))
    assert not tba.k3_gate(c, group=object())                            # sharded


def test_adjust_builds_no_k3_plan_inside_the_lm_loop(monkeypatch):
    """adjust takes K3's plan from the problem: no LM step builds one, and
    every CG iteration of every step goes through K3 with it (on the card
    with_plans builds it once a problem, in ba.plans:
    tests/test_torch_smatvec_cuda.py)."""
    p = with_k3_plan(_f32_problem())
    plans, steps, calls = [], [], []
    orig_plan, orig_step, orig_mv = k3.smatvec_plan, tba.lm_step, k3.smatvec

    def plan(*a, **k):
        plans.append(1)
        return orig_plan(*a, **k)

    def step(*a, **k):
        steps.append(1)
        return orig_step(*a, **k)

    def mv(*a, **k):
        assert (k["plan"] if "plan" in k else a[-1]) is p.k3_plan
        calls.append(1)
        return orig_mv(*a, **k)

    monkeypatch.setattr(k3, "smatvec_plan", plan)
    monkeypatch.setattr(tba, "lm_step", step)
    monkeypatch.setattr(k3, "smatvec", mv)
    _, cost, _ = tba.adjust(p, tba.BAConfig(max_iterations=4, function_tolerance=0.0))
    assert len(steps) >= 3 and len(calls) >= len(steps)
    assert not plans
    assert np.isfinite(cost)
