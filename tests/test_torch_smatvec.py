"""Port parity for kernel K3's plain version and the fused branch of the
Schur-CG solve: openmvg_torch/ops/smatvec.py against
openmvg_tpu/ops/pallas_smatvec.py::s_matvec_halves (Pallas in interpret
mode on the CPU), and schur_cg_solve with OMT_FUSED_SMATVEC=1 against the
same solve unfused.

The matvec cases are the problem of tests/test_pallas_smatvec.py (seed 0,
R = 4) and three more seeds and row widths, float32 on both sides, held to
2e-4 as that test holds the reference.  The kernel itself runs only on
the card (tests/test_torch_smatvec_cuda.py).
"""

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
    fast = tba.cam_fast_ok(p)
    r, Jp6, Ji8, Jx3 = tba.jacobians(p, cfg, fast)
    lam = torch.tensor(1e-4, dtype=p.X.dtype)
    return tba.schur_cg_solve(p, r, Jp6, Ji8, Jx3, lam, cfg)


def test_fused_schur_cg_solve_matches_unfused(monkeypatch):
    """One damped solve of a 6-view float32 problem (poses, intrinsics and
    points free), fused and unfused, both on the CPU.  The two matvecs sum
    in other orders, so float32 rounding (about 1e-7 relative a step)
    enters each CG iteration; the updates agree to 1e-4 of their largest
    magnitude and the predicted gains to 1e-4 relative.  The fused branch
    must have run once per CG iteration."""
    p = _f32_problem()
    monkeypatch.delenv("OMT_FUSED_SMATVEC", raising=False)
    ref = _solve(p)
    calls = []
    orig = k3.smatvec

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(k3, "smatvec", counted)
    monkeypatch.setenv("OMT_FUSED_SMATVEC", "1")
    got = _solve(p)
    assert calls
    for a, b in zip(got[:3], ref[:3]):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale
    assert abs(float(got[3]) - float(ref[3])) <= 1e-4 * abs(float(ref[3]))


def test_fused_gate_declines_what_the_reference_declines(monkeypatch):
    """The gate: the variable set, float32, the point-major layout and a
    group table; anything else takes the unfused matvec."""
    p = _f32_problem()
    Jp6 = torch.zeros((p.obs_pose.shape[0], 2, 6))
    monkeypatch.delenv("OMT_FUSED_SMATVEC", raising=False)
    assert tba._fused_smatvec_plan(p, Jp6) is None
    monkeypatch.setenv("OMT_FUSED_SMATVEC", "1")
    assert tba._fused_smatvec_plan(p, Jp6) is not None
    assert tba._fused_smatvec_plan(p, Jp6.double()) is None               # float64
    t = p.pt_obs
    rows = torch.arange(p.obs_pose.shape[0]).reshape(t.row_point.shape[0], -1)
    assert tba._fused_smatvec_plan(p._replace(pt_obs=t._replace(rows=rows)), Jp6) is None
    assert tba._fused_smatvec_plan(p._replace(pt_obs=t._replace(groups=None)), Jp6) is None
    assert tba._fused_smatvec_plan(p._replace(pt_obs=None), Jp6) is None
