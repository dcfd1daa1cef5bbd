"""Plain bundle adjustment of a BAL problem whose reduced camera system is
too large to form densely: the reference of BAL Final-13682, where the
dense system of reference/bal_lm.py (9 unknowns a camera, 123,138 in
all) would take 121 GB in float64.

Plain PyTorch in float64, written for this benchmark and independent of
the program: the same model, rotation update and Huber loss as bal_lm.py
(its residuals, analytic Jacobians and robust cost, called on blocks of
observations), and the same Levenberg-Marquardt loop.  Departures from
bal_lm.py, all in how a step is solved and in what memory:

  - the reduced camera system S = A - sum_l W_l C_l^-1 W_l^T is held as
    its nonzero 9 x 9 blocks, one for each ordered pair of cameras that
    see a common point (and each camera with itself), assembled from the
    point blocks' Cholesky factors (M_o = L_l^-1 W_o^T, as bal_lm.py
    forms them) in blocks of point pairs, never as a dense matrix;
  - S dc = rhs is solved by conjugate gradients preconditioned with the
    inverse of S's diagonal blocks (block Jacobi), to a relative residual
    of cg_tol (1e-12), in place of bal_lm.py's Cholesky factorisation
    (and its fallback to a general solve where that fails); a loop that
    does not get there in cg_max_iterations gives its last iterate as the
    step, which LM then takes only if the cost falls;
  - the residuals, Jacobians, sums and the back-substitution run over
    blocks of obs_block observations, the assembly over blocks of about
    pair_block point pairs, so the memory stays bounded;
  - the cost is summed block by block in float64 (bal_lm.py sums all the
    observations in one reduction): the two agree to rounding.

Nothing here sets or reads the program's state.  TF32 is set off when
the module is imported: float64 products never use it, and the setting
keeps any float32 use of this module in true float32.
"""

import math

import torch

from benchmark.reference import bal_lm

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HUBER_A = bal_lm.HUBER_A
CG_TOL = 1e-12
expm_so3 = bal_lm.expm_so3


def robust_cost(R, t, intr, X, cam, point, x, pp=None, k3=None, obs_block=1 << 22):
    """0.5 sum rho(|r|^2), summed block by block."""
    return math.fsum(bal_lm.robust_cost(R, t, intr, X, cam[s:s + obs_block],
                                        point[s:s + obs_block], x[s:s + obs_block], pp, k3)
                     for s in range(0, cam.shape[0], obs_block))


class _Structure:
    """What a problem's observation ids fix for every step: the observations
    in point order, the blocks of points whose pairs are assembled
    together, and the nonzero blocks of S (keys cam_a * C + cam_b,
    sorted), with each camera's diagonal block among them."""

    def __init__(self, cam, point, n_cams, n_points, pair_block):
        dev = cam.device
        self.order = torch.argsort(point, stable=True)
        k = torch.bincount(point, minlength=n_points)
        self.k = k
        self.start = torch.zeros(n_points + 1, dtype=torch.int64, device=dev)
        self.start[1:] = torch.cumsum(k, 0)
        # cut the points into runs of about pair_block pairs (k^2 a point)
        pairs = torch.cumsum(k * k, 0).cpu()
        cuts, l0 = [0], 0
        while l0 < n_points:
            l1 = int(torch.searchsorted(pairs, int(pairs[l0 - 1] if l0 else 0) + pair_block,
                                        right=True))
            l0 = max(l1, l0 + 1)
            cuts.append(min(l0, n_points))
        self.blocks = list(zip(cuts[:-1], cuts[1:]))
        self.cam_sorted = cam[self.order]
        keys = [torch.arange(n_cams, device=dev) * (n_cams + 1)]
        for l0, l1 in self.blocks:
            i, j = self.pairs(l0, l1)
            keys.append(torch.unique(self.cam_sorted[i] * n_cams + self.cam_sorted[j]))
        self.keys = torch.unique(torch.cat(keys))
        self.rows = torch.div(self.keys, n_cams, rounding_mode="floor")
        self.cols = self.keys % n_cams
        self.diag = torch.searchsorted(self.keys, torch.arange(n_cams, device=dev) * (n_cams + 1))

    def pairs(self, l0, l1):
        """Positions (in point order) of every ordered pair of observations
        of one point, for the points [l0, l1)."""
        dev = self.k.device
        s0, s1 = int(self.start[l0]), int(self.start[l1])
        lp = torch.repeat_interleave(torch.arange(l0, l1, device=dev), self.k[l0:l1],
                                     output_size=s1 - s0)
        kk = self.k[lp]
        n = int(kk.sum())
        i = torch.repeat_interleave(torch.arange(s0, s1, device=dev), kk, output_size=n)
        first = torch.repeat_interleave(torch.cumsum(kk, 0) - kk, kk, output_size=n)
        j = self.start[torch.repeat_interleave(lp, kk, output_size=n)] + (
            torch.arange(n, device=dev) - first)
        return i, j

    def matvec(self, S, v):
        """S v for S as its blocks (nb, 9, 9), v (C, 9)."""
        y = torch.bmm(S, v[self.cols][:, :, None])[:, :, 0]
        return torch.zeros_like(v).index_add_(0, self.rows, y)


def _pcg(st, S, b, tol, max_iterations):
    """Block-Jacobi preconditioned CG on S x = b; (x, iterations, relative
    residual)."""
    Dl = torch.linalg.cholesky(S[st.diag])

    def precond(r):
        return torch.cholesky_solve(r[:, :, None], Dl)[:, :, 0]

    x = torch.zeros_like(b)
    r = b.clone()
    z = precond(r)
    p = z
    rz = float((r * z).sum())
    bn = float(torch.linalg.vector_norm(b))
    rel = 0.0 if bn == 0 else 1.0
    it = 0
    while it < max_iterations and rel > tol:
        Ap = st.matvec(S, p)
        alpha = rz / float((p * Ap).sum())
        x = x + alpha * p
        r = r - alpha * Ap
        it += 1
        rel = float(torch.linalg.vector_norm(r)) / bn
        z = precond(r)
        rz_new = float((r * z).sum())
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, it, rel


def _step(R, t, intr, X, cam, point, x, lam, st, pp, k3, fix_intr, cg_tol, cg_max_iterations,
          obs_block, stats):
    """One damped Gauss-Newton step (d_cam (C, 9), d_X (L, 3)), or None
    where a point block is not positive definite at this damping."""
    nC, nL, O = R.shape[0], X.shape[0], cam.shape[0]
    dt, dev = X.dtype, X.device
    A = torch.zeros((nC, 9, 9), dtype=dt, device=dev)
    Cp = torch.zeros((nL, 3, 3), dtype=dt, device=dev)
    gc = torch.zeros((nC, 9), dtype=dt, device=dev)
    gx = torch.zeros((nL, 3), dtype=dt, device=dev)
    M = torch.empty((O, 27), dtype=dt, device=dev)   # W_o = wJc^T Jx (9, 3), then M_o (3, 9)
    for s0 in range(0, O, obs_block):
        s = slice(s0, s0 + obs_block)
        c, l = cam[s], point[s]
        r, Jc, Jx = bal_lm._jacobians(R, t, intr, X, c, l, x[s], pp, k3, fix_intr)
        sq = (r * r).sum(1)
        w = torch.where(sq <= HUBER_A, torch.ones_like(sq),
                        torch.sqrt(HUBER_A / torch.clamp(sq, min=1e-300)))
        wJc, wJx = Jc * w[:, None, None], Jx * w[:, None, None]
        A.index_add_(0, c, wJc.transpose(1, 2) @ Jc)
        Cp.index_add_(0, l, wJx.transpose(1, 2) @ Jx)
        gc.index_add_(0, c, (wJc.transpose(1, 2) @ r[:, :, None])[:, :, 0])
        gx.index_add_(0, l, (wJx.transpose(1, 2) @ r[:, :, None])[:, :, 0])
        M[s] = (wJc.transpose(1, 2) @ Jx).reshape(-1, 27)
    eye9 = torch.eye(9, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    A = A + lam * torch.diagonal(A, dim1=1, dim2=2).clamp(min=1e-6)[:, :, None] * eye9
    Cp = Cp + lam * torch.diagonal(Cp, dim1=1, dim2=2).clamp(min=1e-6)[:, :, None] * eye3
    Lc, info = torch.linalg.cholesky_ex(Cp)
    if bool((info != 0).any()):
        return None
    # M_o = L_l^-1 W_o^T, and rhs = -gc + sum_o W_o C_l^-1 gx_l = -gc + sum_o M_o^T y_l
    y = torch.linalg.solve_triangular(Lc, gx[:, :, None], upper=False)[:, :, 0]
    rhs = -gc
    for s0 in range(0, O, obs_block):
        s = slice(s0, s0 + obs_block)
        l = point[s]
        Ms = torch.linalg.solve_triangular(Lc[l], M[s].reshape(-1, 9, 3).transpose(1, 2),
                                           upper=False)
        M[s] = Ms.reshape(-1, 27)
        rhs = rhs.index_add_(0, cam[s], (Ms.transpose(1, 2) @ y[l][:, :, None])[:, :, 0])
    # S's blocks: A on the diagonal, less M_i^T M_j for each pair (i, j) of
    # observations of one point
    S = torch.zeros((st.keys.shape[0], 9, 9), dtype=dt, device=dev)
    S.index_add_(0, st.diag, A)
    for l0, l1 in st.blocks:
        i, j = st.pairs(l0, l1)
        oi, oj = st.order[i], st.order[j]
        pid = torch.searchsorted(st.keys, st.cam_sorted[i] * nC + st.cam_sorted[j])
        Mi, Mj = M[oi].reshape(-1, 3, 9), M[oj].reshape(-1, 3, 9)
        S.index_add_(0, pid, torch.bmm(Mi.transpose(1, 2), Mj), alpha=-1.0)
        del i, j, oi, oj, pid, Mi, Mj
    dc, its, rel = _pcg(st, S, rhs, cg_tol, cg_max_iterations)
    del S
    if stats is not None:
        stats.append(dict(lam=float(lam), cg_iterations=its, cg_rel_residual=rel))
    # d_X = C^-1 (-gx - sum_o W_o^T dc_cam), W_o^T = L_l M_o
    bx = -gx
    for s0 in range(0, O, obs_block):
        s = slice(s0, s0 + obs_block)
        l = point[s]
        Md = M[s].reshape(-1, 3, 9) @ dc[cam[s]][:, :, None]
        bx = bx.index_add_(0, l, (Lc[l] @ Md)[:, :, 0], alpha=-1.0)
    dX = torch.cholesky_solve(bx[:, :, None], Lc)[:, :, 0]
    return dc, dX


def solve(R, t, intr, X, cam, point, x, max_iterations=60, tol=1e-12, pp=None, k3=None,
          fix_intr=False, cg_tol=CG_TOL, cg_max_iterations=20000, obs_block=1 << 21,
          pair_block=1 << 22, stats=None):
    """Levenberg-Marquardt from (R, t, intr, X) until an accepted step
    lowers the cost by at most tol (relative), or max_iterations steps, as
    bal_lm.solve.  pp, k3: fixed principal points and k3 a camera (0 when
    None); fix_intr holds f, k1, k2 too.  stats, a list, gets each solved
    step's damping, CG iterations and relative residual.  Returns (R, t,
    intr, X, cost, steps)."""
    st = _Structure(cam, point, R.shape[0], X.shape[0], pair_block)
    lam = 1e-4
    cost = robust_cost(R, t, intr, X, cam, point, x, pp, k3, obs_block)
    it = 0
    for it in range(1, max_iterations + 1):
        step = _step(R, t, intr, X, cam, point, x, lam, st, pp, k3, fix_intr, cg_tol,
                     cg_max_iterations, obs_block, stats)
        if step is None:
            lam *= 10
            if lam > 1e12:
                break
            continue
        dc, dX = step
        R1 = expm_so3(dc[:, :3]) @ R
        t1, intr1, X1 = t + dc[:, 3:6], intr + dc[:, 6:9], X + dX
        new = robust_cost(R1, t1, intr1, X1, cam, point, x, pp, k3, obs_block)
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
