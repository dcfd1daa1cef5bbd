"""Batched camera resection (counterpart: openmvg_tpu/ops/resection.py):
P3P, Kabsch alignment and the angular metric for the engines, the 6-point
DLT and its pixel error, the K[R|t] decomposition of a projection matrix
and the upright 2-point solver (solver_resection_kernel.cpp,
solver_resection_p3p_*, solver_resection_up2p_kukelova.cpp,
solver_resection_metrics.hpp).

P3P solves the Grunert distance system through a quartic resultant whose
real roots come from ops/polynomial.real_roots; the rigid alignment of
the three points is Kabsch on ops/linalg.svd3 (no cuSOLVER).
Conventions: world->camera x_cam = R X + t; unit bearings.
"""

import torch

from openmvg_torch.ops import linalg, polynomial
from openmvg_torch.ops.fundamental import nullspace

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


def solve_dlt6(x2d, X3d, weights=None):
    """(..., N>=6, 2) pixels + (..., N, 3) world points -> P (..., 3, 4)
    (HZ 7.1 DLT: the null vector of the (2N, 12) design), signed so that
    det(P[:, :3]) > 0."""
    u, v = x2d[..., 0], x2d[..., 1]
    Xh = torch.cat([X3d, torch.ones_like(X3d[..., :1])], -1)
    z = torch.zeros_like(Xh)
    A = torch.cat([torch.cat([Xh, z, -u[..., None] * Xh], -1),
                   torch.cat([z, Xh, -v[..., None] * Xh], -1)], -2)
    if weights is not None:
        A = A * torch.cat([weights, weights], -1)[..., None]
    p = nullspace(A, 1)[..., 0, :]
    P = p.reshape(p.shape[:-1] + (3, 4))
    return P * torch.sign(linalg.det3(P[..., :3]))[..., None, None]


def projection_error_sq(P, x2d, X3d):
    """Squared pixel reprojection error of (..., N, 3) points through a
    (..., 3, 4) P."""
    Xh = torch.cat([X3d, torch.ones_like(X3d[..., :1])], -1)
    y = torch.einsum("...ij,...nj->...ni", P, Xh)
    w = torch.where(y[..., 2].abs() < _EPS, torch.full_like(y[..., 2], _EPS), y[..., 2])
    d = y[..., :2] / w[..., None] - x2d
    return (d * d).sum(-1)


def krt_from_P(P):
    """P (..., 3, 4) = K [R | t] with K upper triangular, positive diagonal
    and K[2, 2] = 1, det R = +1: the RQ decomposition of P[:, :3] by
    Gram-Schmidt on its rows from the last (closed form; no batched
    cuSOLVER call).  A P of negative det(P[:, :3]) is taken as -P."""
    M = P[..., :3]

    def dot(a, b):
        return (a * b).sum(-1, keepdim=True)

    m1, m2, m3 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    k33 = torch.linalg.vector_norm(m3, dim=-1, keepdim=True)
    r3 = m3 / k33
    k23 = dot(m2, r3)
    q2 = m2 - k23 * r3
    k22 = torch.linalg.vector_norm(q2, dim=-1, keepdim=True)
    r2 = q2 / k22
    k13, k12 = dot(m1, r3), dot(m1, r2)
    q1 = m1 - k13 * r3 - k12 * r2
    k11 = torch.linalg.vector_norm(q1, dim=-1, keepdim=True)
    r1 = q1 / k11
    zero = torch.zeros_like(k11)
    K = torch.cat([torch.cat([k11, k12, k13], -1)[..., None, :],
                   torch.cat([zero, k22, k23], -1)[..., None, :],
                   torch.cat([zero, zero, k33], -1)[..., None, :]], -2)
    Rot = torch.stack([r1, r2, r3], -2)
    d = linalg.det3(Rot)
    Rot = Rot * d[..., None, None]
    t = linalg.solve(K, P[..., 3]) * d[..., None]
    return K / K[..., 2:3, 2:3], Rot, t


def solve_up2p(bearings, X3d):
    """Upright 2-point absolute pose (solver_resection_up2p_kukelova.cpp, a
    PoseLib port): gravity-aligned cameras rotate about y by the half-angle
    tangent q; two points give a 4x4 linear system whose elimination
    leaves a quadratic in q.  bearings, X3d (..., 2, 3) -> R (..., 2, 3, 3),
    t (..., 2, 3), valid (..., 2), world->camera x = R X + t."""
    x0, x1 = bearings[..., 0, :], bearings[..., 1, :]
    X0, X1 = X3d[..., 0, :], X3d[..., 1, :]
    zero = torch.zeros_like(x0[..., 0])

    def rows(x, X):
        r0 = torch.stack([-x[..., 2], zero, x[..., 0],
                          X[..., 0] * x[..., 2] - X[..., 2] * x[..., 0]], -1)
        r1 = torch.stack([zero, -x[..., 2], x[..., 1],
                          -X[..., 1] * x[..., 2] - X[..., 2] * x[..., 1]], -1)
        b0 = torch.stack([-2 * X[..., 0] * x[..., 0] - 2 * X[..., 2] * x[..., 2],
                          X[..., 2] * x[..., 0] - X[..., 0] * x[..., 2]], -1)
        b1 = torch.stack([-2 * X[..., 0] * x[..., 1],
                          X[..., 2] * x[..., 1] - X[..., 1] * x[..., 2]], -1)
        return r0, r1, b0, b1

    a0, a1, c0, c1 = rows(x0, X0)
    a2, a3, c2, c3 = rows(x1, X1)
    sol = linalg.solve(torch.stack([a0, a1, a2, a3], -2), torch.stack([c0, c1, c2, c3], -2))
    c2q, c3q = sol[..., 3, 0], sol[..., 3, 1]
    disc = c2q * c2q - 4.0 * c3q
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    # the stable quadratic roots (PoseLib solve_quadratic_real)
    q0 = torch.where(c2q > 0, 2 * c3q / (-c2q - sq), 2 * c3q / (-c2q + sq))
    q1 = c3q / torch.where(q0.abs() < 1e-30, torch.ones_like(q0), q0)
    qs = torch.stack([q0, q1], -1)
    inv_norm = 1.0 / (1.0 + qs * qs)
    cq = (1.0 - qs * qs) * inv_norm
    sn = 2.0 * qs * inv_norm
    one, z2 = torch.ones_like(cq), torch.zeros_like(cq)
    R = torch.stack([torch.stack([cq, z2, sn], -1), torch.stack([z2, one, z2], -1),
                     torch.stack([-sn, z2, cq], -1)], -2)
    t = -(sol[..., :3, 0][..., None, :] * qs[..., :, None]
          + sol[..., :3, 1][..., None, :]) * inv_norm[..., :, None]
    return R, t, (disc >= 0)[..., None].expand(qs.shape)
