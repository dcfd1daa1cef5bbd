"""LAD-ADMM: min ||A x - b||_1 by the alternating direction method of
multipliers (counterpart: openmvg_tpu/ops/l1_admm.py; Boyd et al. 2012,
the least-absolute-deviations instance; numeric/l1_solver_admm.hpp
L1Solver).

The reference's update scheme (x-solve against the Cholesky factor of
A^T A computed once, over-relaxation alpha, soft-thresholding z-update,
dual u-update) for a fixed number of iterations.  Dense products and one
Cholesky factor of an (N, N) matrix: no scatter, so the result is the same
run to run.
"""

import torch


def _shrinkage(v, kappa):
    return torch.sign(v) * torch.clamp(v.abs() - kappa, min=0.0)


def solve_lad(A, b, x0=None, rho=1.0, alpha=1.0, iters=300, ridge=1e-9):
    """Least absolute deviations: argmin_x ||A x - b||_1 for A (M, N),
    b (M,) tensors.  Returns x (N,)."""
    N = A.shape[1]
    AtA = A.T @ A + ridge * torch.eye(N, dtype=A.dtype, device=A.device)
    chol = torch.linalg.cholesky(AtA)
    x = torch.zeros(N, dtype=A.dtype, device=A.device) if x0 is None else x0
    z = torch.zeros(A.shape[0], dtype=A.dtype, device=A.device)
    u = torch.zeros_like(z)
    for _ in range(iters):
        x = torch.cholesky_solve((A.T @ (b + z - u))[:, None], chol)[:, 0]
        ax_hat = alpha * (A @ x) + (1.0 - alpha) * (z + b)
        z = _shrinkage(ax_hat - b + u, 1.0 / rho)
        u = u + ax_hat - z - b
    return x
