"""Batched essential-matrix estimation: 5-point (Nister), 8-point, the
upright and orthographic 3-point solvers, and pose recovery (counterpart:
openmvg_tpu/ops/essential.py; multiview/solver_essential_five_point.cpp,
solver_essential_eight_point.cpp, solver_essential_three_point.cpp,
essential.cpp, motion_from_essential.cpp).

The 5-point solver reduces Nister's ten cubic constraints by elimination
to a 3x3 polynomial system B(z) [x, y, 1]^T = 0 and brackets the real
roots of det B(z) with ops/polynomial.real_roots.  Its 4-dim null space
comes from Gauss-Jordan elimination (fundamental.nullspace_exact) and its
10x10 elimination from ops/linalg.solve: the port keeps batched eigh,
solve and svd out of cuSOLVER (see ops/linalg.py).  The basis is made
orthonormal and mixed (_generic_basis); it differs from the reference's
eigh basis, so the polynomials differ, but the solution set (E up to
scale) is the same.

Convention: b2^T E b1 = 0 on unit bearings (..., N, 3).
"""

import numpy as np
import torch

from openmvg_torch.ops import linalg, polynomial
from openmvg_torch.ops.fundamental import nullspace_exact, point_line_error_sq

_LIN = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]  # x, y, z, 1
_QUAD = [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
         (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
# degree 3: the first 10 are eliminated, the last 10 factor as
# x*(z^2, z, 1), y*(z^2, z, 1), (z^3, z^2, z, 1)
_HIGH = [(3, 0, 0), (2, 1, 0), (1, 2, 0), (0, 3, 0), (2, 0, 1),
         (1, 1, 1), (0, 2, 1), (2, 0, 0), (1, 1, 0), (0, 2, 0)]
_REST = [(1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
         (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0)]
_CUB = _HIGH + _REST


def _table(b1, b2, out):
    T = np.zeros((len(b1), len(b2), len(out)))
    index = {m: i for i, m in enumerate(out)}
    for i, ma in enumerate(b1):
        for j, mb in enumerate(b2):
            s = tuple(a + b for a, b in zip(ma, mb))
            if s in index:
                T[i, j, index[s]] = 1.0
    return T


_T_LL = _table(_LIN, _LIN, _QUAD)
_T_QL = _table(_QUAD, _LIN, _CUB)


def _mul(T, a, b):
    return torch.einsum("abm,...a,...b->...m", torch.as_tensor(T, dtype=a.dtype,
                                                               device=a.device), a, b)


def epipolar_design_bearings(b1, b2):
    """(..., N, 3) -> (..., N, 9) rows of b2^T E b1 = 0 (E row-major)."""
    return (b2[..., :, None] * b1[..., None, :]).reshape(b1.shape[:-1] + (9,))


def _null_vector(A):
    """Unit null vector of (..., N, 9): exact elimination for N < 9,
    least squares (Jacobi eigh of A^T A) otherwise."""
    if A.shape[-2] < 9:
        return nullspace_exact(A)[..., 0, :]
    return linalg.smallest_eigvec(A.transpose(-1, -2) @ A)


def solve_essential_8pt(b1, b2, weights=None):
    """8-point E from bearings, projected to two equal singular values."""
    A = epipolar_design_bearings(b1, b2)
    if weights is not None:
        A = A * weights[..., None]
    E = _null_vector(A).reshape(A.shape[:-2] + (3, 3))
    U, S, Vt = linalg.svd3(E)
    s = (S[..., 0] + S[..., 1]) * 0.5
    S2 = torch.stack([s, s, torch.zeros_like(s)], -1)
    return (U * S2[..., None, :]) @ Vt


def essential_error_sq(E, b1, b2):
    """Squared point-to-epipolar-line distance on the normalized plane."""
    return point_line_error_sq(E, b1[..., :2] / b1[..., 2:3], b2[..., :2] / b2[..., 2:3])


def angular_error(E, b1, b2):
    """Squared asin of the normalized |b2 . E b1| (AngularRadianErrorKernel)."""
    Eb1 = torch.einsum("...ij,...nj->...ni", E, b1)
    num = (b2 * Eb1).sum(-1).abs()
    den = torch.linalg.vector_norm(Eb1, dim=-1) * torch.linalg.vector_norm(b2, dim=-1)
    return torch.arcsin(torch.clamp(num / torch.clamp(den, min=1e-30), 0.0, 1.0)) ** 2


def _constraint_matrix(Ebasis):
    """(..., 4, 3, 3) basis (E = x E0 + y E1 + z E2 + E3) -> (..., 10, 20)
    cubic-constraint coefficients over _CUB."""
    Elin = Ebasis.movedim(-3, -1)          # (..., 3, 3, 4)

    def ll(i, j, k, l):
        return _mul(_T_LL, Elin[..., i, j, :], Elin[..., k, l, :])

    def ql(q, l):
        return _mul(_T_QL, q, l)

    c1 = ll(1, 1, 2, 2) - ll(1, 2, 2, 1)
    c2 = ll(1, 0, 2, 2) - ll(1, 2, 2, 0)
    c3 = ll(1, 0, 2, 1) - ll(1, 1, 2, 0)
    det = ql(c1, Elin[..., 0, 0, :]) - ql(c2, Elin[..., 0, 1, :]) + ql(c3, Elin[..., 0, 2, :])
    P = [[ll(i, 0, k, 0) + ll(i, 1, k, 1) + ll(i, 2, k, 2) for k in range(3)]
         for i in range(3)]
    tr = P[0][0] + P[1][1] + P[2][2]
    rows = [det]
    for i in range(3):
        for j in range(3):
            acc = ql(P[i][0], Elin[..., 0, j, :]) + ql(P[i][1], Elin[..., 1, j, :]) \
                + ql(P[i][2], Elin[..., 2, j, :])
            rows.append(acc - 0.5 * ql(tr, Elin[..., i, j, :]))
    return torch.stack(rows, -2)


# fixed 4x4 orthogonal mixing (normalized Hadamard) of the null-space basis
_MIX = np.array([[1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1], [1, -1, -1, 1]]) / 2.0


def _generic_basis(ns):
    """Orthonormal, mixed basis of a (..., 4, 9) null space.

    Nister's parametrization E = x E0 + y E1 + z E2 + E3 misses every
    solution whose E3 coefficient is zero and loses precision near one.
    Gauss-Jordan rows are unit vectors on the free columns, so E3 owns one
    entry of E alone (E[0, 0] here), and that entry is near zero for a
    sideways motion with little rotation, the common case.  Gram-Schmidt,
    then a fixed orthogonal mix, give E3 a share of every direction, as
    the reference's eigh basis has."""
    q = []
    for i in range(ns.shape[-2]):
        v = ns[..., i, :]
        for u in q:
            v = v - (v * u).sum(-1, keepdim=True) * u
        q.append(v / torch.linalg.vector_norm(v, dim=-1, keepdim=True))
    Q = torch.stack(q, -2)
    return torch.as_tensor(_MIX, dtype=ns.dtype, device=ns.device) @ Q


def solve_essential_5pt(b1, b2):
    """Nister 5-point on bearings (..., 5, 3) -> (E (..., 10, 3, 3),
    valid (..., 10)), up to ten real solutions."""
    A = epipolar_design_bearings(b1, b2)
    Ebasis = _generic_basis(nullspace_exact(A)).reshape(A.shape[:-2] + (4, 3, 3))
    M = _constraint_matrix(Ebasis)
    R = linalg.solve(M[..., :10], M[..., 10:])   # (..., 10, 10)

    def parts(row):
        # REST layout: [xz^2, xz, x, yz^2, yz, y, z^3, z^2, z, 1]
        p = torch.stack([row[..., 2], row[..., 1], row[..., 0]], -1)
        q = torch.stack([row[..., 5], row[..., 4], row[..., 3]], -1)
        r = torch.stack([row[..., 9], row[..., 8], row[..., 7], row[..., 6]], -1)
        return p, q, r

    def shift(c):
        return torch.cat([torch.zeros_like(c[..., :1]), c], -1)

    def padr(c):
        return torch.cat([c, torch.zeros_like(c[..., :1])], -1)

    Bp, Bq, Br = [], [], []
    for a, d in ((7, 4), (8, 5), (9, 6)):
        pa, qa, ra = parts(R[..., a, :])
        pd, qd, rd = parts(R[..., d, :])
        Bp.append(shift(pa) - padr(pd))
        Bq.append(shift(qa) - padr(qd))
        Br.append(shift(ra) - padr(rd))

    pm = polynomial.polymul
    m01 = pm(Bp[1], Bq[2]) - pm(Bp[2], Bq[1])
    m02 = pm(Bp[0], Bq[2]) - pm(Bp[2], Bq[0])
    m03 = pm(Bp[0], Bq[1]) - pm(Bp[1], Bq[0])
    det = pm(Br[0], m01, 11) - pm(Br[1], m02, 11) + pm(Br[2], m03, 11)
    finite = torch.isfinite(det).all(-1)
    det = torch.where(finite[..., None], det, torch.zeros_like(det))
    z, valid = polynomial.real_roots_split(det, max_roots=10)
    valid = valid & finite[..., None]

    def evalp(c):
        return polynomial.polyval(c[..., None, :], z)

    Pz = torch.stack([evalp(p) for p in Bp], -1)
    Qz = torch.stack([evalp(q) for q in Bq], -1)
    Rz = torch.stack([evalp(r) for r in Br], -1)
    a11 = (Pz * Pz).sum(-1)
    a12 = (Pz * Qz).sum(-1)
    a22 = (Qz * Qz).sum(-1)
    bx = -(Pz * Rz).sum(-1)
    by = -(Qz * Rz).sum(-1)
    dn = a11 * a22 - a12 * a12
    dn = torch.where(dn.abs() < 1e-30, torch.full_like(dn, 1e-30), dn)
    x = (bx * a22 - by * a12) / dn
    y = (by * a11 - bx * a12) / dn
    E = (x[..., None, None] * Ebasis[..., None, 0, :, :]
         + y[..., None, None] * Ebasis[..., None, 1, :, :]
         + z[..., None, None] * Ebasis[..., None, 2, :, :]
         + Ebasis[..., None, 3, :, :])
    flat = E.reshape(E.shape[:-2] + (9,))
    nrm = torch.linalg.vector_norm(flat, dim=-1)
    E = E / torch.clamp(nrm, min=1e-30)[..., None, None]
    valid = valid & (nrm > 1e-20) & torch.isfinite(E.reshape(E.shape[:-2] + (9,))).all(-1)
    return E, valid


def motions_from_essential(E):
    """The four (R, t) of E (HZ 9.6.2): R (..., 4, 3, 3), t (..., 4, 3)."""
    U, _, Vt = linalg.svd3(E)
    dU = linalg.det3(U)
    dV = linalg.det3(Vt)
    one = torch.ones_like(dU)
    U = U * torch.stack([one, one, dU], -1)[..., None, :]
    Vt = Vt * torch.stack([one, one, dV], -1)[..., :, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[..., :, 2]
    return torch.stack([Ra, Ra, Rb, Rb], -3), torch.stack([t, -t, t, -t], -2)


def relative_pose_from_essential(E, b1, b2, weights=None):
    """Cheirality-tested (R, t), |t| = 1: the candidate with the most
    weighted points in front of both cameras (motion_from_essential.cpp).
    Returns (R (..., 3, 3), t (..., 3), n_good (...,))."""
    R4, t4 = motions_from_essential(E)
    if weights is None:
        weights = torch.ones(b1.shape[:-1], dtype=E.dtype, device=E.device)
    m0 = torch.einsum("...cij,...nj->...cni", R4, b1)
    m1 = b2[..., None, :, :].expand(m0.shape)
    t = t4[..., None, :].expand(m0.shape)
    z = torch.cross(m1, m0, dim=-1)
    denom = (z * z).sum(-1)
    lam0 = (z * torch.cross(t, m1, dim=-1)).sum(-1) / torch.clamp(denom, min=1e-30)
    lam1 = (z * torch.cross(t, m0, dim=-1)).sum(-1) / torch.clamp(denom, min=1e-30)
    good = (lam0 > 0) & (lam1 > 0) & (denom > 1e-20)
    score = (good.to(E.dtype) * weights[..., None, :]).sum(-1)
    best = torch.argmax(score, dim=-1)
    R = torch.take_along_dim(R4, best[..., None, None, None], dim=-3).squeeze(-3)
    tt = torch.take_along_dim(t4, best[..., None, None], dim=-2).squeeze(-2)
    n_good = torch.take_along_dim(score, best[..., None], dim=-1).squeeze(-1)
    return R, tt, n_good


# ---------------------------------------------------------------------------
# upright (gravity-aligned) and orthographic 3-point solvers
# (solver_essential_three_point.cpp)
# ---------------------------------------------------------------------------

def _minor3(A, cols):
    """Determinants of the (..., 3, 3) submatrices of (..., 3, 4) A on `cols`."""
    return linalg.det3(A[..., :, cols])


def solve_essential_upright_3pt(b1, b2):
    """ThreePointUprightRelativePoseSolver: for cameras that rotate about
    the y axis and move in the horizontal plane, E has four free entries
    (E01, E10, E12, E21), linear in the epipolar constraints.  Three
    bearings (..., 3, 3) give a 3x4 system whose null vector is the four
    signed 3x3 minors (closed form, no SVD); returns (E (..., 3, 3) of
    unit norm, valid (...,)), invalid when the three rows are dependent."""
    ax, ay, az = b1[..., 0], b1[..., 1], b1[..., 2]
    bx, by, bz = b2[..., 0], b2[..., 1], b2[..., 2]
    A = torch.stack([ax * by, -az * by, -bx * ay, -bz * ay], dim=-1)   # (..., 3, 4)
    n = torch.stack([_minor3(A, [1, 2, 3]), -_minor3(A, [0, 2, 3]),
                     _minor3(A, [0, 1, 3]), -_minor3(A, [0, 1, 2])], dim=-1)
    nrm = torch.linalg.vector_norm(n, dim=-1)
    valid = (nrm > 1e-300) & torch.isfinite(nrm)
    n = n / torch.clamp(nrm, min=1e-300)[..., None]
    zero = torch.zeros_like(n[..., 0])
    E = torch.stack([torch.stack([zero, n[..., 2], zero], -1),
                     torch.stack([-n[..., 0], zero, n[..., 1]], -1),
                     torch.stack([zero, n[..., 3], zero], -1)], -2)
    return E, valid


def solve_essential_ortho_3pt(x1, x2):
    """Orthographic two-view 3-point solver (Oskarsson, JMIV 2017;
    ThreePointsRelativePose): a quartic in d reduced to a quadratic in d^2,
    two candidates of the form [[0, 0, a], [0, 0, b], [c, d, e]].

    x1, x2 (..., 3, 2) camera-plane points.  Returns E (..., 2, 3, 3) and a
    (..., 2) validity mask; the reference's guards (|denom| < 1e-30,
    d4_4 == 0, a negative discriminant or root) are kept as they are."""
    xd1 = x1[..., 1, :] - x1[..., 0, :]
    yd1 = x1[..., 2, :] - x1[..., 0, :]
    xd2 = x2[..., 1, :] - x2[..., 0, :]
    yd2 = x2[..., 2, :] - x2[..., 0, :]
    one = torch.ones_like(xd1[..., 0])
    denom = xd1[..., 0] * yd1[..., 1] - xd1[..., 1] * yd1[..., 0]
    safe = torch.where(denom.abs() < 1e-30, one, denom)
    aac = (xd1[..., 1] * yd2[..., 0] - xd2[..., 0] * yd1[..., 1]) / safe
    aad = (xd1[..., 1] * yd2[..., 1] - xd2[..., 1] * yd1[..., 1]) / safe
    bbc = (xd2[..., 0] * yd1[..., 0] - xd1[..., 0] * yd2[..., 0]) / safe
    bbd = (xd2[..., 1] * yd1[..., 0] - xd1[..., 0] * yd2[..., 1]) / safe

    aac_sq = aac * aac
    dd_2 = -aac_sq + aad * aad - bbc * bbc + bbd * bbd
    dd_1c = 2.0 * aac * aad + 2.0 * bbc * bbd
    dd_0 = aac_sq + bbc * bbc - 1.0
    d4_4 = dd_1c * dd_1c + dd_2 * dd_2
    d4_2 = -dd_1c * dd_1c + 2.0 * dd_0 * dd_2
    d4_0 = dd_0 * dd_0
    disc = d4_2 * d4_2 - 4.0 * d4_4 * d4_0
    ok_disc = disc >= 0
    tmp = torch.sqrt(torch.clamp(disc, min=0.0))

    def build(root):
        ratio = -root / torch.where(d4_4 == 0, one, d4_4) / 2.0
        ok = ok_disc & (ratio >= 0) & (d4_4 != 0)
        dsol = torch.sqrt(torch.clamp(ratio, min=0.0))
        den = 2.0 * aac * aad * dsol + 2.0 * bbc * bbd * dsol
        csol = -(dd_2 * dsol * dsol + aac_sq + bbc * bbc - 1.0) / \
            torch.where(den.abs() < 1e-30, one, den)
        asol = aac * csol + aad * dsol
        bsol = bbc * csol + bbd * dsol
        esol = (-asol * x1[..., 0, 0] - bsol * x1[..., 0, 1]
                - csol * x2[..., 0, 0] - dsol * x2[..., 0, 1])
        zero = torch.zeros_like(asol)
        E = torch.stack([torch.stack([zero, zero, asol], -1),
                         torch.stack([zero, zero, bsol], -1),
                         torch.stack([csol, dsol, esol], -1)], -2)
        return E, ok

    E_a, ok_a = build(d4_2 + tmp)
    E_b, ok_b = build(d4_2 - tmp)
    return torch.stack([E_a, E_b], dim=-3), torch.stack([ok_a, ok_b], dim=-1)


def ortho_essential_error_sq(E, x1, x2):
    """Squared algebraic error x1h^T E x2h of orthographic E on (..., N, 2)
    points (the solver's convention, solver_essential_three_point.cpp:66-79)."""
    ones = torch.ones(x1.shape[:-1] + (1,), dtype=x1.dtype, device=x1.device)
    x1h = torch.cat([x1, ones], dim=-1)
    x2h = torch.cat([x2, ones], dim=-1)
    val = torch.einsum("...ni,...ij,...nj->...n", x1h, E, x2h)
    return val * val
