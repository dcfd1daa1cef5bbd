"""Batched triangulation: the four 2-view methods and algebraic N-view
(counterpart: openmvg_tpu/ops/triangulation.py; multiview/triangulation.cpp,
triangulation_nview.cpp).

Poses are world->camera (R, t) with x_cam = R X + t; bearings are unit
(or scale-free) rays; every function broadcasts over leading dimensions
and returns (X, ok) with ok the method's cheirality test.  The 4x4
eigenproblems go through ops/linalg.eigh (Jacobi), not cuSOLVER.
"""

import torch

from openmvg_torch.ops import linalg

DIRECT_LINEAR_TRANSFORM = 0
L1_ANGULAR = 1
LINFINITY_ANGULAR = 2
INVERSE_DEPTH_WEIGHTED_MIDPOINT = 3  # reference default

_EPS = 1e-30


def _mv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def _cross(a, b):
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return torch.cross(a.expand(shape), b.expand(shape), dim=-1)


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def _relative(R0, t0, R1, t1, b0):
    R = R1 @ R0.transpose(-1, -2)
    t = t1 - _mv(R, t0)
    return R, t, _mv(R, b0)


def _point_from_depths(m0, m1, t, R1, t1):
    """triangulation.cpp Compute3DPoint."""
    z = _cross(m1, m0)
    zz = (z * z).sum(-1)
    lam0 = (z * _cross(t, m1)).sum(-1) / torch.clamp(zz, min=_EPS)
    lam1 = (z * _cross(t, m0)).sum(-1) / torch.clamp(zz, min=_EPS)
    xprime1 = t + lam0[..., None] * m0
    X = torch.einsum("...ji,...j->...i", R1, xprime1 - t1)
    return X, (lam0 > 0) & (lam1 > 0)


def _dehomogenize(Xh):
    w = Xh[..., 3]
    w = torch.where(w.abs() < _EPS, torch.full_like(w, _EPS), w)
    return Xh[..., :3] / w[..., None]


def triangulate_dlt(R0, t0, b0, R1, t1, b1):
    """HZ 12.2 DLT from two [R|t]."""
    P0 = torch.cat([R0, t0[..., None]], -1)
    P1 = torch.cat([R1, t1[..., None]], -1)
    A = torch.stack([
        b0[..., 0, None] * P0[..., 2, :] - b0[..., 2, None] * P0[..., 0, :],
        b0[..., 1, None] * P0[..., 2, :] - b0[..., 2, None] * P0[..., 1, :],
        b1[..., 0, None] * P1[..., 2, :] - b1[..., 2, None] * P1[..., 0, :],
        b1[..., 1, None] * P1[..., 2, :] - b1[..., 2, None] * P1[..., 1, :],
    ], -2)
    X = _dehomogenize(linalg.smallest_eigvec(A.transpose(-1, -2) @ A))
    d0 = _mv(R0, X)[..., 2] + t0[..., 2]
    d1 = _mv(R1, X)[..., 2] + t1[..., 2]
    return X, (d0 > 0) & (d1 > 0)


def triangulate_l1_angular(R0, t0, b0, R1, t1, b1):
    """Lee & Civera L1-angular (triangulation.cpp:117-146)."""
    _, t, m0 = _relative(R0, t0, R1, t1, b0)
    m1 = b1
    m0n = m0 / _norm(m0)[..., None]
    m1n = m1 / _norm(m1)[..., None]
    use0 = (_cross(m0n, t) ** 2).sum(-1) <= (_cross(m1n, t) ** 2).sum(-1)
    n1 = _cross(m1, t)
    n1 = n1 / torch.clamp(_norm(n1), min=_EPS)[..., None]
    mp0 = m0 - (m0 * n1).sum(-1, keepdim=True) * n1
    n0 = _cross(m0, t)
    n0 = n0 / torch.clamp(_norm(n0), min=_EPS)[..., None]
    mp1 = m1 - (m1 * n0).sum(-1, keepdim=True) * n0
    am0 = torch.where(use0[..., None], mp0, m0)
    am1 = torch.where(use0[..., None], m1, mp1)
    return _point_from_depths(am0, am1, t, R1, t1)


def triangulate_linf_angular(R0, t0, b0, R1, t1, b1):
    """Lee & Civera L-infinity-angular (triangulation.cpp:148-177)."""
    _, t, m0 = _relative(R0, t0, R1, t1, b0)
    m1 = b1
    m0n = m0 / _norm(m0)[..., None]
    m1n = m1 / _norm(m1)[..., None]
    na = _cross(m0n + m1n, t)
    nb = _cross(m0n - m1n, t)
    pick_a = (na * na).sum(-1) >= (nb * nb).sum(-1)
    nprime = torch.where(pick_a[..., None], na, nb)
    nprime = nprime / torch.clamp(_norm(nprime), min=_EPS)[..., None]
    mp0 = m0 - (m0 * nprime).sum(-1, keepdim=True) * nprime
    mp1 = m1 - (m1 * nprime).sum(-1, keepdim=True) * nprime
    return _point_from_depths(mp0, mp1, t, R1, t1)


def triangulate_idw_midpoint(R0, t0, b0, R1, t1, b1):
    """Inverse-depth-weighted midpoint (triangulation.cpp:179-216)."""
    _, t, Rb0 = _relative(R0, t0, R1, t1, b0)
    p_norm = _norm(_cross(Rb0, b1))
    q_norm = _norm(_cross(Rb0, t))
    r_norm = _norm(_cross(b1, t))
    denom = torch.clamp(q_norm + r_norm, min=_EPS)
    pn = torch.clamp(p_norm, min=_EPS)
    xprime1 = (q_norm / denom)[..., None] * (t + (r_norm / pn)[..., None] * (Rb0 + b1))
    X = torch.einsum("...ji,...j->...i", R1, xprime1 - t1)
    lam0_Rb0 = (r_norm / pn)[..., None] * Rb0
    lam1_b1 = (q_norm / pn)[..., None] * b1
    base = ((t + lam0_Rb0 - lam1_b1) ** 2).sum(-1)
    alt = torch.minimum(torch.minimum(((t + lam0_Rb0 + lam1_b1) ** 2).sum(-1),
                                      ((t - lam0_Rb0 - lam1_b1) ** 2).sum(-1)),
                        ((t - lam0_Rb0 + lam1_b1) ** 2).sum(-1))
    return X, base < alt


_METHODS = {
    DIRECT_LINEAR_TRANSFORM: triangulate_dlt,
    L1_ANGULAR: triangulate_l1_angular,
    LINFINITY_ANGULAR: triangulate_linf_angular,
    INVERSE_DEPTH_WEIGHTED_MIDPOINT: triangulate_idw_midpoint,
}


def triangulate_2view(R0, t0, b0, R1, t1, b1, method=INVERSE_DEPTH_WEIGHTED_MIDPOINT):
    """Triangulate2View dispatch (triangulation.cpp:219-252)."""
    return _METHODS[int(method)](R0, t0, b0, R1, t1, b1)


def triangulate_nview(Rs, ts, bearings, weights=None):
    """Algebraic N-view triangulation: minimise sum_i |b_i x (R_i X + t_i)|^2.

    Rs (..., V, 3, 3), ts (..., V, 3), bearings (..., V, 3); weights
    (..., V) mask views.  Returns (X (..., 3), ok) with ok = positive
    depth along the bearing in every weighted view, (R_i X + t_i) . b_i > 0
    (CheiralityTest of sfm_data_triangulation.cpp).  The reference tests
    the camera z instead, which refuses every point behind a SPHERICAL
    camera's optical axis; for a pinhole view whose reprojection is within
    any threshold the two agree."""
    from openmvg_torch.geometry.so3 import skew

    if weights is None:
        weights = torch.ones(bearings.shape[:-1], dtype=bearings.dtype, device=bearings.device)
    P = torch.cat([Rs, ts[..., None]], -1)                   # (..., V, 3, 4)
    A = (skew(bearings) @ P) * weights[..., None, None]
    A = A.reshape(A.shape[:-3] + (-1, 4))
    X = _dehomogenize(linalg.smallest_eigvec(A.transpose(-1, -2) @ A))
    depth = ((torch.einsum("...vij,...j->...vi", Rs, X) + ts) * bearings).sum(-1)
    ok = ((depth > 0) | (weights <= 0)).all(-1)
    return X, ok
