"""Batched 4-point DLT homography and the asymmetric transfer error
(counterpart: openmvg_tpu/ops/homography.py;
multiview/solver_homography_kernel.cpp FourPointSolver, AsymmetricError).

Convention: x2 ~ H x1, points (..., N, 2).  The minimal 8x9 system has a
one-dimensional null space, taken by Gauss-Jordan elimination
(fundamental.nullspace_exact); more than four points take the least-squares
vector (Jacobi eigh of A^T A).  No batched SVD, which the reference uses.
"""

import torch

from openmvg_torch.ops import linalg
from openmvg_torch.ops.fundamental import nullspace_exact


def homography_design(x1, x2):
    """DLT rows: each correspondence gives 2 rows of (..., 2N, 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([u1, v1, o, z, z, z, -u1 * u2, -v1 * u2, -u2], dim=-1)
    r2 = torch.stack([z, z, z, u1, v1, o, -u1 * v2, -v1 * v2, -v2], dim=-1)
    return torch.cat([r1, r2], dim=-2)


def solve_homography(x1, x2, weights=None):
    """(..., N >= 4, 2) pairs -> (..., 3, 3) H of unit Frobenius norm (its
    sign is arbitrary, as the reference's SVD vector's is)."""
    A = homography_design(x1, x2)
    if weights is not None:
        A = A * torch.cat([weights, weights], dim=-1)[..., None]
    if A.shape[-2] < 9:
        h = nullspace_exact(A)[..., 0, :]
    else:
        h = linalg.smallest_eigvec(A.transpose(-1, -2) @ A)
    h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-30)
    return h.reshape(h.shape[:-1] + (3, 3))


def asymmetric_error_sq(H, x1, x2):
    """Squared transfer distance |x2 - proj(H x1)|^2: H (..., 3, 3), x1/x2
    (..., N, 2) -> (..., N)."""
    num = torch.einsum("...ij,...nj->...ni", H[..., :2, :2], x1) + H[..., None, :2, 2]
    den = torch.einsum("...j,...nj->...n", H[..., 2, :2], x1) + H[..., None, 2, 2]
    den = torch.where(den.abs() < 1e-30, torch.full_like(den, 1e-30), den)
    d = num / den[..., None] - x2
    return (d * d).sum(-1)
