"""The bundle adjuster at sizes past one pass, on the CPU: the Jacobian
blocks evaluated in chunks of rows (openmvg_torch/sfm/ba.py::jacobians
with jac_slots) against the one-pass blocks, bit for bit; the chunk the
card's free memory gives (jac_chunk_slots); and kernel K3's plain
version with its plan built from the rows' points alone
(ops/smatvec.py::smatvec_plan), on a problem whose group table
build_pt_obs leaves out, against the unfused matvec.
"""

import types

import numpy as np
import pytest
import torch

from benchmark.drivers import ba_solve
from benchmark.gen import bal
from openmvg_torch.models import cameras as cm
from openmvg_torch.ops import smatvec as k3
from openmvg_torch.sfm import ba


def _problem(dtype="float64", kind=cm.PINHOLE_RADIAL_K3, n_obs=1300):
    """A small BAL-like problem (the benchmark's generator and layout):
    camera model 3 takes the polynomial closed form, PINHOLE its own closed
    form, fisheye the generic Jacobians."""
    prob = bal.make_problem(None, 12, 240, n_obs, problem_seed=3)
    p = ba_solve.program_problem(prob, dict(camera_model=cm.PINHOLE_RADIAL_K3,
                                            image_wh=[2000, 2000], dtype=dtype), "cpu")
    if kind == cm.PINHOLE:
        mask = torch.zeros_like(p.mask_intr)
        mask[:, 0] = 1.0
        p = p._replace(intr_kind=torch.full_like(p.intr_kind, cm.PINHOLE), mask_intr=mask)
    elif kind != cm.PINHOLE_RADIAL_K3:
        p = p._replace(intr_kind=torch.full_like(p.intr_kind, kind))
    return p


def _slots_a_row(p):
    return p.obs_pose.shape[0] // p.pt_obs.row_point.shape[0]


@pytest.mark.parametrize("rows", [1, 5, 50])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", [cm.PINHOLE_RADIAL_K3, cm.PINHOLE, cm.PINHOLE_FISHEYE])
def test_chunked_jacobians_equal_the_one_pass_bit_for_bit(kind, dtype, rows):
    """Each row's blocks depend on that row alone, so chunks of a few rows
    (the last one short) give the one-pass blocks bit for bit, in the same
    strides, on each of the three paths."""
    p = _problem(dtype, kind)
    cfg = ba.BAConfig()
    fast = ba.cam_fast_ok(p)
    assert fast == {cm.PINHOLE_RADIAL_K3: ba.JAC_POLY, cm.PINHOLE: ba.JAC_PINHOLE,
                    cm.PINHOLE_FISHEYE: ba.JAC_GENERIC}[kind]
    ref = ba.jacobians(p, cfg, fast)
    step = rows * _slots_a_row(p)
    assert p.obs_pose.shape[0] % step or rows == 1
    got = ba.jacobians(p._replace(jac_slots=step), cfg, fast)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.stride() == b.stride()
        assert torch.equal(a, b)


def test_chunked_jacobians_of_the_gather_form():
    """Gather-form tables (rows not None): chunks of any slots, the points
    gathered through obs_point."""
    p = _problem()
    t = p.pt_obs
    L1 = t.row_point.shape[0]
    rows = torch.arange(p.obs_pose.shape[0]).reshape(L1, -1)
    p = p._replace(pt_obs=t._replace(rows=rows))
    cfg = ba.BAConfig()
    ref = ba.jacobians(p, cfg)
    got = ba.jacobians(p._replace(jac_slots=7), cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_a_solve_with_chunked_jacobians_is_bit_identical():
    """float32 adjust, one pass against chunks of 5 rows: the same costs,
    parameters and accepted steps."""
    p = _problem("float32")
    cfg = ba.BAConfig(max_iterations=5)
    a = ba.adjust(p, cfg)
    b = ba.adjust(p._replace(jac_slots=5 * _slots_a_row(p)), cfg)
    assert a[1] == b[1] and a[2] == b[2]
    for f in ("rotvec", "t", "intr_params", "X"):
        assert torch.equal(getattr(a[0], f), getattr(b[0], f))


@pytest.mark.parametrize("free_gib,expect", [(64.0, None), (0.004, "chunks"),
                                             (0.0005, "closed_form_chunks")])
def test_the_chunk_comes_from_the_free_memory(free_gib, expect, monkeypatch):
    """jac_chunk_slots: half of what the process can still allocate (the
    card's free memory and the allocator's unused cache), less the blocks
    jacobians returns, over the path's bytes a slot (JAC_BYTES_PER_SLOT for
    the generic path, JAC_CLOSED_BYTES_PER_SLOT for a closed form), in
    whole rows; None where one pass fits.  The closed form's case has no
    unused cache, since its few bytes a slot would fit this problem in
    3 MiB."""
    closed = expect == "closed_form_chunks"
    p = _problem("float32")
    O, R = p.obs_pose.shape[0], _slots_a_row(p)
    free, cached = int(free_gib * 2 ** 30), (0 if closed else 3 << 20)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (free, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev=None: cached + (5 << 20))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: 5 << 20)
    path = ba.JAC_POLY if closed else ba.JAC_GENERIC
    got = ba.jac_chunk_slots(p, path)
    if expect is None:
        assert got is None
        return
    per_slot = ba.JAC_BYTES_PER_SLOT if path == ba.JAC_GENERIC else ba.JAC_CLOSED_BYTES_PER_SLOT
    slots = (free + cached - O * 36 * 4) // 2 // per_slot
    assert got == slots // R * R and 0 < got < O and got % R == 0


def _layout_without_groups(p):
    """p laid out again through build_pt_obs with a group budget too small
    for the table, as a problem over 1 << 24 table elements is."""
    t = ba.build_pt_obs(p.obs_point.numpy(), p.obs_w.numpy(), p.X.shape[0],
                        group_budget_elems=16)
    assert t.groups is None
    assert torch.equal(torch.as_tensor(t.row_point), p.pt_obs.row_point)
    return p._replace(pt_obs=ba.PtObsTable(rows=None, row_point=p.pt_obs.row_point,
                                           groups=None))


def _k3_plan(p):
    t = p.pt_obs
    return k3.smatvec_plan(p.obs_pose, p.obs_intr, t.row_point, p.X.shape[0],
                           p.rotvec.shape[0], p.intr_params.shape[0])


def _solve(p):
    cfg = ba.BAConfig()
    r, Jp6, Ji8, Jx3 = ba.jacobians(p, cfg, ba.cam_fast_ok(p))
    return ba.schur_cg_solve(p, r, Jp6, Ji8, Jx3, torch.tensor(1e-4, dtype=p.X.dtype), cfg)


def test_k3_plain_without_a_group_table_equals_the_unfused_matvec(monkeypatch):
    """A float32 problem without a group table: K3's plan built from
    row_point alone, the CG matvec through K3's plain version, one damped
    solve against the unfused matvec.  The two sum in other orders, so
    float32 rounding enters each CG iteration: the updates agree to 1e-4
    of their largest magnitude, the predicted gains to 1e-4 relative (the
    bounds of tests/test_torch_smatvec.py's solve with a table).  The gate
    takes the problem on the card."""
    p = _layout_without_groups(_problem("float32"))
    claims = p._replace(X=types.SimpleNamespace(is_cuda=True, dtype=torch.float32))
    assert ba.k3_gate(claims)
    calls = []
    orig = k3.smatvec

    def counted(*a, **k):
        calls.append(a[9])
        return orig(*a, **k)

    monkeypatch.setattr(k3, "smatvec", counted)
    ref = _solve(p)
    assert not calls
    got = _solve(p._replace(k3_plan=_k3_plan(p)))
    assert calls and all(g is None for g in calls)
    for a, b in zip(got[:3], ref[:3]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert abs(float(got[3]) - float(ref[3])) <= 1e-4 * abs(float(ref[3]))


def test_k3_plain_folds_rows_through_row_point_as_through_the_table():
    """In float64 the plain version without a table (rows folded into their
    points through row_point) equals the one with it, and the plan built
    from row_point alone equals the one checked against the table."""
    p = _problem()
    t = p.pt_obs
    cfg = ba.BAConfig()
    _, Jp6, Ji8, Jx3 = ba.jacobians(p, cfg)
    g = torch.Generator().manual_seed(5)
    P, I, L = p.rotvec.shape[0], p.intr_params.shape[0], p.X.shape[0]
    vp = torch.randn((P, 6), generator=g, dtype=torch.float64)
    vi = torch.randn((I, 8), generator=g, dtype=torch.float64)
    A = torch.randn((L, 3, 3), generator=g, dtype=torch.float64)
    hinv = torch.linalg.inv(A @ A.transpose(1, 2) + 3 * torch.eye(3, dtype=torch.float64))
    args = [Jp6, Ji8, Jx3, p.obs_pose, p.obs_intr, vp, vi, hinv, t.row_point]
    with_table = k3.smatvec_plain(*args, t.groups)
    without = k3.smatvec_plain(*args, None)
    for a, b in zip(without, with_table):
        assert float((a - b).abs().max()) <= 1e-12 * (1 + float(b.abs().max()))
    plan = _k3_plan(p)
    pt_row0 = np.concatenate([[0], np.cumsum(np.bincount(t.row_point.numpy(), minlength=L))])
    assert np.array_equal(plan.pt_row0.numpy(), pt_row0)
    got = k3.smatvec(*args, None, plan=plan)
    assert all(torch.equal(a, b) for a, b in zip(got, without))
