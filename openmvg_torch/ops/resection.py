"""Batched camera resection: P3P, Kabsch alignment and the angular metric
(counterpart: openmvg_tpu/ops/resection.py, the parts the incremental
engine reaches; solver_resection_p3p_*, solver_resection_metrics.hpp).

P3P solves the Grunert distance system through a quartic resultant whose
real roots come from ops/polynomial.real_roots; the rigid alignment of
the three points is Kabsch on ops/linalg.svd3 (no cuSOLVER).
Conventions: world->camera x_cam = R X + t; unit bearings.
"""

import torch

from openmvg_torch.ops import linalg, polynomial

_EPS = 1e-30


def solve_p3p(bearings, X3d):
    """(..., 3, 3) bearings + (..., 3, 3) world points ->
    (R (..., 4, 3, 3), t (..., 4, 3), valid (..., 4))."""
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    P1, P2, P3 = X3d[..., 0, :], X3d[..., 1, :], X3d[..., 2, :]
    a2 = ((P2 - P3) ** 2).sum(-1)
    b2 = ((P1 - P3) ** 2).sum(-1)
    c2 = ((P1 - P2) ** 2).sum(-1)
    ca = (f2 * f3).sum(-1)
    cb = (f1 * f3).sum(-1)
    cg = (f1 * f2).sum(-1)
    ra = a2 / torch.clamp(c2, min=_EPS)
    rb = b2 / torch.clamp(c2, min=_EPS)
    zero, one = torch.zeros_like(ra), torch.ones_like(ra)
    A2 = torch.stack([1.0 - ra], -1)
    A1 = torch.stack([2 * ra * cg, -2 * ca], -1)
    A0 = torch.stack([-ra, zero, one], -1)
    B2 = torch.stack([-rb], -1)
    B1 = torch.stack([2 * rb * cg], -1)
    B0 = torch.stack([1.0 - rb, -2 * cb, one], -1)
    pm = polynomial.polymul
    t1 = pm(A2, B0, 3) - pm(A0, B2, 3)
    t2 = pm(A2, B1, 2) - pm(A1, B2, 2)
    t3 = pm(A1, B0, 4) - pm(A0, B1, 4)
    res = pm(t1, t1, 5) - pm(t2, t3, 5)
    v, valid = polynomial.real_roots(res, max_roots=4)
    t2v = polynomial.polyval(t2[..., None, :], v)
    t1v = polynomial.polyval(t1[..., None, :], v)
    u = -t1v / torch.where(t2v.abs() < _EPS, torch.full_like(t2v, _EPS), t2v)
    denom = 1.0 + u * u - 2.0 * u * cg[..., None]
    s1 = torch.sqrt(torch.clamp(c2[..., None], min=0.0) / torch.clamp(denom, min=1e-12))
    s2 = u * s1
    s3 = v * s1
    valid = valid & (s1 > 0) & (s2 > 0) & (s3 > 0) & (denom > 1e-12)
    Q = torch.stack([s1[..., None] * f1[..., None, :], s2[..., None] * f2[..., None, :],
                     s3[..., None] * f3[..., None, :]], -2)   # (..., 4, 3, 3)
    Pw = X3d[..., None, :, :].expand(Q.shape)
    R, t = kabsch(Pw, Q)
    valid = valid & torch.isfinite(R.reshape(R.shape[:-2] + (9,))).all(-1)
    return R, t, valid


def kabsch(P, Q):
    """Rigid (R, t) minimising |Q - (R P + t)|^2 over rows (..., N, 3)."""
    muP, muQ = P.mean(-2), Q.mean(-2)
    H = torch.einsum("...ni,...nj->...ij", P - muP[..., None, :], Q - muQ[..., None, :])
    U, _, Vt = linalg.svd3(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = linalg.det3(V @ Ut)
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    R = V @ (D[..., :, None] * Ut)
    t = muQ - torch.einsum("...ij,...j->...i", R, muP)
    return R, t


def bearing_angular_error(R, t, bearings, X3d):
    """Squared angle between each bearing and R X + t (ANGULAR_ERROR)."""
    Xc = torch.einsum("...ij,...nj->...ni", R, X3d) + t[..., None, :]
    Xc = Xc / torch.clamp(torch.linalg.vector_norm(Xc, dim=-1, keepdim=True), min=_EPS)
    return torch.arccos(torch.clamp((Xc * bearings).sum(-1), -1.0, 1.0)) ** 2
