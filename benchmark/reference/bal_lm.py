"""Plain bundle adjustment of a BAL problem: the benchmark's reference.

Plain PyTorch, written for this benchmark and independent of the
program: rotations as matrices updated on the left by exp([d]x), analytic
Jacobians of PINHOLE_CAMERA_RADIAL3 with the principal point and k3 at 0,
the Huber loss of ceres (HuberLoss(4): rho(s) = s up to 16, 2 sqrt(16 s)
- 16 beyond) by reweighting, and Levenberg-Marquardt steps solved exactly:
the reduced camera system is formed densely (9 parameters a camera) and
factored by Cholesky.  The point blocks are eliminated through their
Cholesky factors, M_l = L_l^-1 W_l^T, so the Schur complement is
A - sum_l M_l^T M_l, a product of dense blocks of rows.

`robust_cost` is the cost the comparison reads; `solve` runs LM until the
cost stops falling.  The dtype is the caller's: float64 for the
reference, float32 (with TF32 allowed by the caller) for the control.
"""

import math

import torch

HUBER_A = 16.0


def _hat(v):
    z = torch.zeros_like(v[:, 0])
    return torch.stack([torch.stack([z, -v[:, 2], v[:, 1]], -1),
                        torch.stack([v[:, 2], z, -v[:, 0]], -1),
                        torch.stack([-v[:, 1], v[:, 0], z], -1)], 1)


def expm_so3(w):
    """(N, 3) rotation vectors -> (N, 3, 3)."""
    th = torch.linalg.vector_norm(w, dim=1)[:, None, None]
    K = _hat(w / torch.clamp(th[:, :, 0], min=1e-300))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(th) * K + (1 - torch.cos(th)) * (K @ K)


def residuals(R, t, intr, X, cam, point, x, pp=None, k3=None):
    """Reprojection residuals (O, 2), camera-frame points, their
    normalised coordinates, r^2 and the distortion factor.  intr is (f,
    k1, k2) a camera; pp (C, 2) and k3 (C,), 0 when not given."""
    Xc = torch.einsum("oij,oj->oi", R[cam], X[point]) + t[cam]
    p = Xc[:, :2] / Xc[:, 2:]
    r2 = (p * p).sum(1, keepdim=True)
    f, k1, k2 = intr[cam, 0:1], intr[cam, 1:2], intr[cam, 2:3]
    d = 1 + k1 * r2 + k2 * r2 * r2
    if k3 is not None:
        d = d + k3[cam, None] * r2 * r2 * r2
    px = f * d * p
    if pp is not None:
        px = px + pp[cam]
    return px - x, Xc, p, r2, d


def robust_cost(R, t, intr, X, cam, point, x, pp=None, k3=None):
    """0.5 sum rho(|r|^2)."""
    r = residuals(R, t, intr, X, cam, point, x, pp, k3)[0]
    s = (r * r).sum(1)
    rho = torch.where(s <= HUBER_A, s, 2 * torch.sqrt(HUBER_A * s) - HUBER_A)
    return 0.5 * float(rho.sum())


def _jacobians(R, t, intr, X, cam, point, x, pp=None, k3=None, fix_intr=False):
    """Residuals (O, 2), camera blocks (O, 2, 9) [d rotation (left), t, f,
    k1, k2] and point blocks (O, 2, 3); with fix_intr the intrinsic
    columns are 0."""
    r, Xc, p, r2, d = residuals(R, t, intr, X, cam, point, x, pp, k3)
    f, k1, k2 = intr[cam, 0:1], intr[cam, 1:2], intr[cam, 2:3]
    z = Xc[:, 2:]
    zero = torch.zeros_like(z)
    dp_dXc = torch.stack([torch.cat([1 / z, zero, -Xc[:, 0:1] / (z * z)], 1),
                          torch.cat([zero, 1 / z, -Xc[:, 1:2] / (z * z)], 1)], 1)
    dk = k1 + 2 * k2 * r2 + (3 * k3[cam, None] * r2 * r2 if k3 is not None else 0)
    dd_dp = 2 * dk * p  # (O, 2)
    eye2 = torch.eye(2, dtype=X.dtype, device=X.device)
    dproj_dp = f[:, :, None] * (d[:, :, None] * eye2 + p[:, :, None] * dd_dp[:, None, :])
    J_Xc = dproj_dp @ dp_dXc                                   # (O, 2, 3)
    RX = Xc - t[cam]
    J_rot = -(J_Xc @ _hat(RX))                                 # d/dw of exp([w]x) R X
    J_intr = torch.stack([d * p, f * r2 * p, f * r2 * r2 * p], 2)  # (O, 2, 3)
    if fix_intr:
        J_intr = torch.zeros_like(J_intr)
    Jc = torch.cat([J_rot, J_Xc, J_intr], 2)
    Jx = J_Xc @ R[cam]
    return r, Jc, Jx


def _sum_blocks(vals, ids, n):
    return torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                       device=vals.device).index_add_(0, ids, vals)


def _step(R, t, intr, X, cam, point, x, lam, rows_per_chunk, pp=None, k3=None,
          fix_intr=False):
    """One damped Gauss-Newton step (d_cam (C, 9), d_X (L, 3)), or None
    where a point block is not positive definite at this damping."""
    nC, nL = R.shape[0], X.shape[0]
    r, Jc, Jx = _jacobians(R, t, intr, X, cam, point, x, pp, k3, fix_intr)
    s = (r * r).sum(1)
    w = torch.where(s <= HUBER_A, torch.ones_like(s),
                    torch.sqrt(HUBER_A / torch.clamp(s, min=1e-300)))
    wJc, wJx = Jc * w[:, None, None], Jx * w[:, None, None]
    A = _sum_blocks(wJc.transpose(1, 2) @ Jc, cam, nC)        # (C, 9, 9)
    Cp = _sum_blocks(wJx.transpose(1, 2) @ Jx, point, nL)     # (L, 3, 3)
    W = wJc.transpose(1, 2) @ Jx                              # (O, 9, 3)
    gc = _sum_blocks((wJc.transpose(1, 2) @ r[:, :, None])[:, :, 0], cam, nC)
    gx = _sum_blocks((wJx.transpose(1, 2) @ r[:, :, None])[:, :, 0], point, nL)
    eye9 = torch.eye(9, dtype=X.dtype, device=X.device)
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    A = A + lam * torch.diagonal(A, dim1=1, dim2=2).clamp(min=1e-6)[:, :, None] * eye9
    Cp = Cp + lam * torch.diagonal(Cp, dim1=1, dim2=2).clamp(min=1e-6)[:, :, None] * eye3
    Lc, info = torch.linalg.cholesky_ex(Cp)                   # (L, 3, 3)
    if bool((info != 0).any()):
        return None
    # M rows of each point: L_l^-1 W_o^T, (O, 3, 9)
    M = torch.linalg.solve_triangular(Lc[point], W.transpose(1, 2), upper=False)
    n = 9 * nC
    S = torch.zeros((n, n), dtype=X.dtype, device=X.device)
    idx = torch.arange(nC, device=X.device)
    S.view(nC, 9, nC, 9)[idx, :, idx, :] = A
    col = (cam[:, None] * 9 + torch.arange(9, device=X.device)).reshape(-1, 1, 9)
    for p0 in range(0, nL, rows_per_chunk):
        p1 = min(p0 + rows_per_chunk, nL)
        sel = torch.nonzero((point >= p0) & (point < p1))[:, 0]
        D = torch.zeros(((p1 - p0) * 3, n), dtype=X.dtype, device=X.device)
        row = ((point[sel] - p0) * 3)[:, None, None] + torch.arange(3, device=X.device)[:, None]
        D.index_put_((row.expand(-1, 3, 9), col[sel].expand(-1, 3, 9)), M[sel],
                     accumulate=True)
        S -= D.T @ D
    # rhs = -gc + W C^-1 gx
    Cgx = torch.cholesky_solve(gx[:, :, None], Lc)[:, :, 0]
    rhs = -gc + _sum_blocks((W @ Cgx[point][:, :, None])[:, :, 0], cam, nC)
    S = 0.5 * (S + S.T)
    Ls, info = torch.linalg.cholesky_ex(S)
    if int(info) != 0:
        dc = torch.linalg.solve(S, rhs.reshape(-1))
    else:
        dc = torch.cholesky_solve(rhs.reshape(-1, 1), Ls)[:, 0]
    dc = dc.reshape(nC, 9)
    bx = -gx - _sum_blocks((W.transpose(1, 2) @ dc[cam][:, :, None])[:, :, 0], point, nL)
    dX = torch.cholesky_solve(bx[:, :, None], Lc)[:, :, 0]
    return dc, dX


def solve(R, t, intr, X, cam, point, x, max_iterations=60, tol=1e-12, rows_per_chunk=40000,
          pp=None, k3=None, fix_intr=False):
    """Levenberg-Marquardt from (R, t, intr, X) until an accepted step
    lowers the cost by at most tol (relative), or max_iterations steps.
    pp, k3: fixed principal points and k3 a camera (0 when None);
    fix_intr holds f, k1, k2 too.  Returns (R, t, intr, X, cost, steps)."""
    lam = 1e-4
    cost = robust_cost(R, t, intr, X, cam, point, x, pp, k3)
    it = 0
    for it in range(1, max_iterations + 1):
        step = _step(R, t, intr, X, cam, point, x, lam, rows_per_chunk, pp, k3, fix_intr)
        if step is None:
            lam *= 10
            if lam > 1e12:
                break
            continue
        dc, dX = step
        R1 = expm_so3(dc[:, :3]) @ R
        t1, intr1, X1 = t + dc[:, 3:6], intr + dc[:, 6:9], X + dX
        new = robust_cost(R1, t1, intr1, X1, cam, point, x, pp, k3)
        if math.isfinite(new) and new < cost:
            done = cost - new <= tol * cost
            R, t, intr, X, cost = R1, t1, intr1, X1, new
            lam = max(lam / 3, 1e-12)
            if done:
                break
        else:
            lam *= 10
            if lam > 1e12:
                break
    return R, t, intr, X, cost, it
