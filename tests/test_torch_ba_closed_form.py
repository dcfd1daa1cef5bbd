"""The bundle adjuster's closed-form Jacobians of the polynomial camera
kinds 2, 3 and 4 (openmvg_torch/sfm/ba.py::_poly_r_J) against the
forward-mode Jacobians over every kind (_generic_r_J), in float64 on the
CPU, and the choice of path (cam_fast_ok): PINHOLE keeps its own closed
form bit for bit, fisheye, spherical and mixed problems keep forward mode,
and ba.jac_closed counts the chunks a closed form computed.
"""

import pytest
import torch

from benchmark.drivers import ba_solve
from benchmark.gen import bal
from openmvg_torch.geometry import so3
from openmvg_torch.models import cameras as cm
from openmvg_torch.sfm import ba
from openmvg_torch.utils import logging as omt

POLY = [cm.PINHOLE_RADIAL_K1, cm.PINHOLE_RADIAL_K3, cm.PINHOLE_BROWN]
# the distortion columns k1, k2, k3, t1, t2 each kind uses
DISTO = {cm.PINHOLE_RADIAL_K1: (-0.08, 0, 0, 0, 0),
         cm.PINHOLE_RADIAL_K3: (-0.08, 0.012, -0.002, 0, 0),
         cm.PINHOLE_BROWN: (-0.08, 0.012, -0.002, 1.5e-3, -2e-3)}


def _problem(kind=cm.PINHOLE_RADIAL_K3, disto=True, dtype="float64", gather=False,
             edges=True):
    """A small BAL-like problem (the benchmark's generator and layout) with
    every intrinsic of `kind`; edges: camera 0 turned by under the
    small-angle threshold (|w|^2 < 1e-8) and one point put in camera 0's
    focal plane (|z| < 1e-12, which clamp_depth clamps); gather: the same
    rows as a gather table."""
    prob = bal.make_problem(None, 12, 240, 1300, problem_seed=3)
    p = ba_solve.program_problem(prob, dict(camera_model=cm.PINHOLE_RADIAL_K3,
                                            image_wh=[2000, 2000], dtype=dtype), "cpu")
    dt = p.X.dtype
    params = p.intr_params.clone()
    params[:, 3:8] = torch.tensor(DISTO.get(kind, DISTO[cm.PINHOLE_BROWN]) if disto
                                  else (0.0,) * 5, dtype=dt)
    p = p._replace(intr_kind=torch.full_like(p.intr_kind, kind), intr_params=params)
    if edges:
        rotvec = p.rotvec.clone()
        rotvec[0] = torch.tensor([3e-5, -4e-5, 2e-5], dtype=dt)
        X = p.X.clone()
        slot = int(torch.nonzero((p.obs_pose == 0) & (p.obs_w > 0))[0, 0])
        point = int(p.obs_point[slot])
        X[point] = so3.rotate(-rotvec[0], torch.tensor([0.3, -0.2, 0.0], dtype=dt) - p.t[0])
        p = p._replace(rotvec=rotvec, X=X)
        Xc = so3.rotate(rotvec[0], X[point]) + p.t[0]
        assert float((rotvec[0] ** 2).sum()) < 1e-8 and abs(float(Xc[2])) < 1e-12
    if gather:
        t = p.pt_obs
        rows = torch.arange(p.obs_pose.shape[0]).reshape(t.row_point.shape[0], -1)
        p = p._replace(pt_obs=t._replace(rows=rows))
    return p


def _close(got, ref, tol=1e-12):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.all((got - ref).abs() <= tol * (1.0 + ref.abs())), \
        float(((got - ref).abs() / (1.0 + ref.abs())).max())


@pytest.mark.parametrize("gather", [False, True], ids=["point_major", "gather"])
@pytest.mark.parametrize("disto", [True, False], ids=["distorted", "zero_distortion"])
@pytest.mark.parametrize("kind", POLY)
def test_closed_form_equals_forward_mode(kind, disto, gather):
    """r and every block of _poly_r_J within 1e-12 (1 + |J|) of the
    forward-mode blocks in float64, the residuals of both paths' costs too:
    the small-angle rotation, the clamped depth and zero distortion
    included."""
    p = _problem(kind, disto, gather=gather)
    assert ba.cam_fast_ok(p) == ba.JAC_POLY
    closed = ba._poly_r_J(p)
    for got, ref in zip(closed, ba._generic_r_J(p)):
        _close(got, ref)
    _close(ba.residuals(p, ba.JAC_POLY), ba.residuals(p, ba.JAC_GENERIC))
    # the clamped slot's depth column (d r / d t_z) is zero, as forward mode gives
    Xc = so3.rotate(p.rotvec[p.obs_pose], ba._pt_expand(p.X, p)) + p.t[p.obs_pose]
    clamped = Xc[:, 2].abs() < 1e-12
    assert int(clamped.sum()) == 1
    assert torch.all(closed[1][clamped][..., 5] == 0)


def _parent_pinhole_r_J(p):
    """sfm/ba.py's _fast_pinhole_r_J before the pose and point rows were
    shared with the polynomial closed form, as it was: the yardstick of
    PINHOLE's blocks."""
    r, w, X, zs, px, py, f = ba._fast_pinhole_project(p)
    invz = 1.0 / zs
    z3 = torch.zeros_like(invz)
    A0 = torch.stack([f * invz, z3, -f * px * invz], -1)
    A1 = torch.stack([z3, f * invz, -f * py * invz], -1)
    JX0 = so3.rotate(-w, A0)
    JX1 = so3.rotate(-w, A1)
    Jx3 = torch.stack([JX0, JX1], -2)
    th2 = (w * w).sum(-1)
    small = th2 < 1e-8
    th = torch.sqrt(torch.clamp(th2, min=1e-16))
    b = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(th)) / torch.clamp(th2, min=1e-16))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / torch.clamp(th2 * th, min=1e-24))

    def row_jw(JXk):
        u = torch.cross(JXk, X, dim=-1)
        uw = torch.cross(u, w, dim=-1)
        return -(u - b[:, None] * uw + c[:, None] * torch.cross(uw, w, dim=-1))

    Jp6 = torch.cat([torch.stack([row_jw(JX0), row_jw(JX1)], -2),
                     torch.stack([A0, A1], -2)], -1)
    O = r.shape[0]
    zc = torch.zeros(O, dtype=r.dtype, device=r.device)
    oc = torch.ones(O, dtype=r.dtype, device=r.device)
    Ji8 = torch.cat([torch.stack([torch.stack([px, oc, zc], -1),
                                  torch.stack([py, zc, oc], -1)], -2),
                     torch.zeros((O, 2, p.intr_params.shape[1] - 3), dtype=r.dtype,
                                 device=r.device)], -1)
    return r, Jp6, Ji8, Jx3


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_pinhole_keeps_its_closed_form_bit_for_bit(dtype):
    p = _problem(cm.PINHOLE, dtype=dtype)
    assert ba.cam_fast_ok(p) == ba.JAC_PINHOLE
    for got, ref in zip(ba._fast_pinhole_r_J(p), _parent_pinhole_r_J(p)):
        assert torch.equal(got, ref)


def _session():
    omt.clear_records()
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _alternating(a, b):
    """A problem whose cameras take the kinds a and b in turn."""
    p = _problem(a)
    kinds = p.intr_kind.clone()
    kinds[1::2] = b
    return p._replace(intr_kind=kinds)


@pytest.mark.parametrize("make,path", [
    (lambda: _problem(cm.PINHOLE), ba.JAC_PINHOLE),
    (lambda: _problem(cm.PINHOLE_RADIAL_K1), ba.JAC_POLY),
    (lambda: _problem(cm.PINHOLE_BROWN), ba.JAC_POLY),
    (lambda: _problem(cm.PINHOLE_FISHEYE), ba.JAC_GENERIC),
    (lambda: _problem(cm.SPHERICAL), ba.JAC_GENERIC),
    (lambda: _alternating(cm.PINHOLE_RADIAL_K3, cm.PINHOLE_BROWN), ba.JAC_POLY),
    (lambda: _alternating(cm.PINHOLE_RADIAL_K3, cm.PINHOLE), ba.JAC_GENERIC),
    (lambda: _alternating(cm.PINHOLE_RADIAL_K3, cm.PINHOLE_FISHEYE), ba.JAC_GENERIC),
    (lambda: _alternating(cm.PINHOLE_BROWN, cm.SPHERICAL), ba.JAC_GENERIC),
], ids=["pinhole", "radial_k1", "brown", "fisheye", "spherical", "k3_and_brown",
        "k3_and_pinhole", "k3_and_fisheye", "brown_and_spherical"])
def test_the_path_follows_the_kinds_and_jac_closed_counts_it(make, path, monkeypatch):
    """cam_fast_ok picks the path in one host read; a solve runs that
    path's residuals and Jacobians alone, and ba.jac_closed counts every
    chunk on a closed form and none on forward mode."""
    p = make()
    calls = {"generic": 0, "pinhole": 0, "poly": 0}
    for name, fn in (("generic", "_generic_r_J"), ("pinhole", "_fast_pinhole_r_J"),
                     ("poly", "_poly_r_J")):
        orig = getattr(ba, fn)

        def counted(q, name=name, orig=orig):
            calls[name] += 1
            return orig(q)

        monkeypatch.setattr(ba, fn, counted)
    with _session():
        assert ba.cam_fast_ok(p) == path
        reads = sum(s.name == "host_read" for s in omt.records()["spans"])
        ba.adjust(p._replace(jac_slots=40 * (p.obs_pose.shape[0]
                                             // p.pt_obs.row_point.shape[0])),
                  ba.BAConfig(max_iterations=2))
    assert reads == 1
    c = omt.records()["counters"]
    want = {ba.JAC_GENERIC: "generic", ba.JAC_PINHOLE: "pinhole", ba.JAC_POLY: "poly"}[path]
    assert calls[want] == c["ba.jac_chunks"] > 2
    assert sum(calls.values()) == calls[want]
    assert c["ba.jac_closed"] == (0 if path == ba.JAC_GENERIC else c["ba.jac_chunks"])
    omt.clear_records()


def test_a_float64_solve_takes_the_generic_path_s_steps():
    """Six float64 LM steps on a camera-3 problem (the generator's start,
    without the edge cases, whose enormous residuals would make the
    comparison one of CG's conditioning) through the closed form and
    through forward mode: the same accepts and rejects, the costs within
    1e-10 relative at every step."""
    p0 = _problem(cm.PINHOLE_RADIAL_K3, edges=False)
    cfg = ba.BAConfig(function_tolerance=0.0)
    runs = []
    for path in (ba.JAC_POLY, ba.JAC_GENERIC):
        p, lam, seq = p0, torch.tensor(cfg.lam_init, dtype=torch.float64), []
        for _ in range(6):
            p, lam, cost, acc = ba.lm_step(p, lam, cfg, path)
            seq.append((bool(acc), float(cost)))
        runs.append(seq)
    (a, b) = runs
    assert [s[0] for s in a] == [s[0] for s in b] and any(s[0] for s in a)
    for (_, ca), (_, cb) in zip(a, b):
        assert abs(ca - cb) <= 1e-10 * abs(cb)
