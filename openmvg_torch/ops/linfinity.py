"""L-infinity triangulation and resection (counterpart:
openmvg_tpu/ops/linfinity.py; openMVG linearProgramming/lInfinityCV
triangulation.cpp and resection.cpp, the Kahl-Hartley quasi-convex
problems of "Multiple-View Geometry under the L_inf Norm", PAMI 2008).

Bisection on the residual bound gamma; at each step a feasibility test of
the linear constraint set A(gamma) x <= c(gamma):

  triangulation (x = X in R^3, EncodeTriangulation, triangulation.cpp:33):
    +-(R1 - u R3) X - gamma R3 X <= -+(t1 - u t3) + gamma t3   (same for v)
    -R3 X <= t3                                   (positive depth)
  resection (x = p in R^11, the rows of P with p34 = 1, EncodeResection,
    resection.cpp:44): the same pattern with P unknown, and depth
    p3x . X + 1 > 0.

The reference tests feasibility with a simplex (bisectionLP.hpp); here,
as in the JAX package, by damped Gauss-Newton on sum relu(A x - c)^2 from
the last feasible point, feasible when the largest violation is at most
tol.  Every problem of a batch runs the same fixed counts (n_bisect,
n_inner), so the whole bisection is one batched float64 computation on
the device with no host read; the small normal equations go through
ops/linalg (Gauss-Jordan, no cuSOLVER).  The algebraic initial points
(the reference's SVD and least squares) are solved on the host in numpy,
one batched call each.  No engine calls these solvers.

Each feasibility decision compares the violation after n_inner steps
with tol, and near the optimal gamma that test turns on the last bits of
the iterate.  So the bisection uses only multiplication, addition,
division and comparisons, which round alike on every device (torch.sqrt
does not: float64 sqrt on the H100 and on the CPU differ in the last bit),
and every sum is a fixed pairwise tree (tree_sum), where matmul's and
einsum's summation orders differ between devices: the card and the CPU
take the same decisions and return the same bits.

Why the same bits, and not the plain batched matmul: the reference runs
only on the CPU, so the card's path is checked against this module's own
CPU run.  With device-dependent rounding one late decision flips for some
problem of a large batch (the H100 read 3.5% apart from the CPU on 1,000
tracks with matmul and torch.sqrt), and the check could then hold the card
only to gamma within a bisection step, loose enough to pass a fault in
the device code.  With the same decisions the card is held to the CPU
within 1e-6 relative.
"""

import numpy as np
import torch

from openmvg_torch.ops import linalg


def tree_sum(v, dim):
    """Sum over `dim` in a fixed pairwise order (zero-padded to a power of
    two, then halved), the same on every device."""
    v = v.movedim(dim, -1)
    n = v.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        v = torch.cat([v, v.new_zeros(v.shape[:-1] + (p - n,))], -1)
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _matvec(A, x):
    """(B, m, n) @ (B, n) -> (B, m)."""
    return tree_sum(A * x[:, None, :], -1)


def _gram(A, Aw):
    """Aw^T A (B, n, n), summed over the m rows."""
    return tree_sum(Aw[..., :, :, None] * A[..., :, None, :], -3)


def _feasible_point(A, c, x0, n_inner, lam=1e-8):
    """Damped Gauss-Newton on sum relu(A x - c)^2 from x0, for (B, m, n) A,
    (B, m) c, (B, n) x0.  Returns (x, max violation (B,))."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    x = x0
    for _ in range(n_inner):
        r = _matvec(A, x) - c
        Aw = A * (r > 0).to(A.dtype)[..., None]
        g = tree_sum(Aw * torch.clamp(r, min=0.0)[..., None], -2)
        x = x - linalg.solve(_gram(A, Aw) + lam * eye, g)
    return x, (_matvec(A, x) - c).max(-1).values


def _bisect(encode, x0, gamma_hi, n_bisect, n_inner, tol=1e-6):
    """Bisection on gamma over a batch: encode(gamma (B,)) -> (A, c).
    Returns (x of the smallest feasible gamma tried, that gamma); a row with
    no feasible step keeps x0 and gamma_hi."""
    lo = torch.zeros_like(gamma_hi)
    hi, x_best, g_best = gamma_hi, x0, gamma_hi
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        A, c = encode(mid)
        x, viol = _feasible_point(A, c, x_best, n_inner)
        ok = viol <= tol
        lo = torch.where(ok, lo, mid)
        hi = torch.where(ok, mid, hi)
        x_best = torch.where(ok[:, None], x, x_best)
        g_best = torch.where(ok, mid, g_best)
    return x_best, g_best


def _masked(rows, rhs, valid):
    """Rows of invalid observations become 0 <= 1."""
    keep = valid[..., None]
    return (torch.where(keep[..., None], rows, torch.zeros_like(rows)),
            torch.where(keep, rhs, torch.ones_like(rhs)))


def _encode_triangulation(P, x, valid, gamma):
    """P (B, V, 3, 4), x (B, V, 2), valid (B, V), gamma (B,) -> A (B, 5V, 3),
    c (B, 5V)."""
    R, t = P[..., :3], P[..., 3]
    u, v = x[..., 0:1], x[..., 1:2]
    r1, r2, r3 = R[..., 0, :], R[..., 1, :], R[..., 2, :]
    t1, t2, t3 = t[..., 0], t[..., 1], t[..., 2]
    g = gamma[:, None]
    rows = torch.stack([r1 - u * r3 - g[..., None] * r3, r2 - v * r3 - g[..., None] * r3, -r3,
                        -r1 + u * r3 - g[..., None] * r3, -r2 + v * r3 - g[..., None] * r3], -2)
    rhs = torch.stack([-t1 + u[..., 0] * t3 + g * t3, -t2 + v[..., 0] * t3 + g * t3, t3,
                       t1 - u[..., 0] * t3 + g * t3, t2 - v[..., 0] * t3 + g * t3], -1)
    rows, rhs = _masked(rows, rhs, valid)
    B = P.shape[0]
    return rows.reshape(B, -1, 3), rhs.reshape(B, -1)


def _flat(a, keep):
    return a.reshape((-1,) + a.shape[keep:])


def triangulate_linf(P, x, valid=None, X_init=None, n_bisect=16, n_inner=25):
    """L-infinity triangulation of tracks: P (..., V, 3, 4) projection
    matrices (pixel or normalised units; gamma is in the units of x),
    x (..., V, 2) observations, valid (..., V).  Returns (X (..., 3), gamma
    (...)), gamma the certified bound on every valid residual."""
    lead = P.shape[:-3]
    P, x = _flat(P, -3), _flat(x, -2)
    valid = (torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device) if valid is None
             else _flat(valid, -1))
    w = valid.to(P.dtype)[..., None]
    if X_init is None:
        # the algebraic DLT point: the last right singular vector of the
        # (2V, 4) rows, on the host
        rows = torch.cat([(x[..., 0:1] * P[..., 2, :] - P[..., 0, :]) * w,
                          (x[..., 1:2] * P[..., 2, :] - P[..., 1, :]) * w], -2)
        Xh = np.linalg.svd(rows.cpu().numpy(), full_matrices=False)[2][..., -1, :]
        w4 = Xh[..., 3:4]
        X_init = torch.as_tensor(Xh[..., :3] / np.where(np.abs(w4) < 1e-12, 1e-12, w4),
                                 device=P.device)
    else:
        X_init = _flat(X_init, -1)
    Xh1 = torch.cat([X_init, torch.ones_like(X_init[..., :1])], -1)
    Xc = tree_sum(P * Xh1[:, None, None, :], -1)
    z = Xc[..., 2]
    z = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    res = (Xc[..., :2] / z[..., None] - x).abs() * w
    gamma_hi = 2.0 * res.amax((-1, -2)) + 1e-3
    X, g = _bisect(lambda gm: _encode_triangulation(P, x, valid, gm), X_init, gamma_hi,
                   n_bisect, n_inner)
    return X.reshape(lead + (3,)), g.reshape(lead)


def _encode_resection(x2d, X3d, valid, gamma):
    """x2d (B, N, 2), X3d (B, N, 3), valid (B, N), gamma (B,) -> A (B, 5N, 11),
    c (B, 5N) over p = [P row 1 (4), P row 2 (4), P row 3 (3)]."""
    Xh = torch.cat([X3d, torch.ones_like(X3d[..., :1])], -1)
    z4, z3 = torch.zeros_like(Xh), torch.zeros_like(X3d)
    u, v = x2d[..., 0:1], x2d[..., 1:2]
    g = gamma[:, None, None]
    d_p = torch.cat([z4, z4, X3d], -1)            # depth = p3x . X + 1
    r1_p = torch.cat([Xh, z4, z3], -1)
    r2_p = torch.cat([z4, Xh, z3], -1)
    rows = torch.stack([r1_p - (u + g) * d_p, r2_p - (v + g) * d_p, -d_p,
                        -r1_p + (u - g) * d_p, -r2_p + (v - g) * d_p], -2)
    gg = g[..., 0]
    rhs = torch.stack([u[..., 0] + gg, v[..., 0] + gg, torch.ones_like(gg.expand_as(u[..., 0])),
                       -(u[..., 0] - gg), -(v[..., 0] - gg)], -1)
    rows, rhs = _masked(rows, rhs, valid)
    B = x2d.shape[0]
    return rows.reshape(B, -1, 11), rhs.reshape(B, -1)


def resection_linf(x2d, X3d, valid=None, n_bisect=16, n_inner=30):
    """L-infinity projective resection (>= 6 points): x2d (..., N, 2),
    X3d (..., N, 3), valid (..., N).  Returns (P (..., 3, 4) with
    P[2, 3] = 1, gamma (...))."""
    lead = x2d.shape[:-2]
    x2d, X3d = _flat(x2d, -2), _flat(X3d, -2)
    valid = (torch.ones(x2d.shape[:-1], dtype=torch.bool, device=x2d.device) if valid is None
             else _flat(valid, -1))
    Xh = torch.cat([X3d, torch.ones_like(X3d[..., :1])], -1)
    z = torch.zeros_like(Xh)
    rows = torch.cat([torch.cat([Xh, z, -x2d[..., 0:1] * X3d], -1),
                      torch.cat([z, Xh, -x2d[..., 1:2] * X3d], -1)], -2)
    rhs = torch.cat([x2d[..., 0], x2d[..., 1]], -1)
    w = torch.cat([valid, valid], -1).to(x2d.dtype)
    rows, rhs = rows * w[..., None], rhs * w
    # the DLT least squares for p0 (on the host, as the reference's lstsq)
    rows_np, rhs_np = rows.cpu().numpy(), rhs.cpu().numpy()
    p0 = torch.as_tensor(np.stack([np.linalg.lstsq(a, b, rcond=None)[0]
                                   for a, b in zip(rows_np, rhs_np)]), device=x2d.device)

    def P_of(p):
        return torch.cat([p, torch.ones_like(p[..., :1])], -1).reshape(p.shape[:-1] + (3, 4))

    Xc = tree_sum(Xh[..., None, :] * P_of(p0)[:, None], -1)
    zz = Xc[..., 2]
    zz = torch.where(zz.abs() < 1e-12, torch.full_like(zz, 1e-12), zz)
    res = (Xc[..., :2] / zz[..., None] - x2d).abs() * valid.to(x2d.dtype)[..., None]
    gamma_hi = 2.0 * res.amax((-1, -2)) + 1e-3
    p, g = _bisect(lambda gm: _encode_resection(x2d, X3d, valid, gm), p0, gamma_hi,
                   n_bisect, n_inner)
    return P_of(p).reshape(lead + (3, 4)), g.reshape(lead)
