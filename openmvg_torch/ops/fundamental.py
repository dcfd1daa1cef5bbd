"""Batched fundamental-matrix solvers and the point-to-line error
(counterpart: openmvg_tpu/ops/fundamental.py;
multiview/solver_fundamental_kernel.{hpp,cpp}).

Convention: x2^T F x1 = 0 for inhomogeneous points (..., N, 2); F is
(..., 3, 3).  The 7-point solver takes its null space from Gauss-Jordan
elimination (`nullspace_exact`), because cuSOLVER refused the batched
eigh of its 9x9 normal matrices; only the 8-point solver uses eigh of
A^T A.
"""

import numpy as np
import torch

from openmvg_torch.ops import polynomial

# inverse Vandermonde for the nodes (-1, 0, 1, 2), lowest degree first
_NODES = np.array([-1.0, 0.0, 1.0, 2.0])
_VANDER_INV = np.linalg.inv(np.vander(_NODES, 4, increasing=True))


def epipolar_design(x1, x2):
    """(..., N, 2) -> (..., N, 9) rows of x2^T F x1 = 0, F row-major."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    o = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o],
                       dim=-1)


def nullspace(A, k=1):
    """Last k right-singular vectors of (..., N, M) via eigh(A^T A):
    (..., k, M), the smallest singular value's vector first."""
    AtA = A.transpose(-1, -2) @ A
    _, V = torch.linalg.eigh(AtA)
    return V[..., :k].transpose(-1, -2)


def nullspace_exact(A):
    """Null space of full-row-rank (..., r, m) matrices, r < m, by
    Gauss-Jordan elimination with full pivoting -> (..., m - r, m) unit
    rows (a basis, not orthonormal).

    The 7-point solver takes this in place of eigh(A^T A): it squares no
    condition number, and it runs as plain tensor ops, where a batched
    eigh of tens of thousands of 9x9 matrices goes to cuSOLVER (which
    refused such a batch on the H100 with CUSOLVER_STATUS_INVALID_VALUE).
    A rank-deficient sample yields a non-finite basis; its models then
    score +inf and never win."""
    lead, (r, m) = A.shape[:-2], A.shape[-2:]
    M = A.reshape(-1, r, m).clone()
    B = M.shape[0]
    b = torch.arange(B, device=A.device)
    perm = torch.arange(m, device=A.device).expand(B, m).clone()
    for k in range(r):
        sub = M[:, k:, k:].abs().reshape(B, -1)
        flat = torch.argmax(sub, dim=-1)
        pr = k + flat // (m - k)
        pc = k + flat % (m - k)
        rows = M[b, pr].clone()            # swap rows k <-> pr
        M[b, pr] = M[:, k].clone()
        M[:, k] = rows
        cols = M[b, :, pc].clone()         # swap columns k <-> pc
        M[b, :, pc] = M[:, :, k].clone()
        M[:, :, k] = cols
        pk = perm[b, pc].clone()
        perm[b, pc] = perm[:, k].clone()
        perm[:, k] = pk
        M[:, k] = M[:, k] / M[:, k, k:k + 1]
        f = M[:, :, k].clone()
        f[:, k] = 0
        M = M - f[:, :, None] * M[:, None, k]
    # M = [I_r | N] in permuted column order: basis vector j is -N[:, j]
    # on the pivot columns and e_j on free column r + j
    n_free = m - r
    Xp = torch.zeros((B, n_free, m), dtype=A.dtype, device=A.device)
    Xp[:, :, :r] = -M[:, :, r:].transpose(1, 2)
    Xp[:, torch.arange(n_free), r + torch.arange(n_free)] = 1.0
    X = torch.zeros_like(Xp).scatter(2, perm[:, None, :].expand(B, n_free, m), Xp)
    X = X / torch.linalg.vector_norm(X, dim=-1, keepdim=True)
    return X.reshape(lead + (n_free, m))


def solve_8pt(x1, x2):
    """8-point (HZ 11.2): (..., N>=8, 2) pairs -> (..., 3, 3) rank-2 F."""
    f = nullspace(epipolar_design(x1, x2), 1)[..., 0, :]
    F = f.reshape(f.shape[:-1] + (3, 3))
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return (U * S[..., None, :]) @ Vt


def _det3(M):
    """Cofactor determinant of (..., 3, 3)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def solve_7pt(x1, x2):
    """7-point solver: (..., 7, 2) -> (F (..., 3, 3, 3), valid (..., 3)).

    F = F1 + a F2 over the 2-dim null space; det(F1 + a F2) is a cubic
    whose coefficients come from its values at 4 nodes."""
    A = epipolar_design(x1, x2)
    ns = nullspace_exact(A)
    F1 = ns[..., 0, :].reshape(ns.shape[:-2] + (3, 3))
    F2 = ns[..., 1, :].reshape(ns.shape[:-2] + (3, 3))
    dets = torch.stack([_det3(F1 + float(t) * F2) for t in _NODES], dim=-1)
    Vinv = torch.as_tensor(_VANDER_INV, dtype=A.dtype, device=A.device)
    coeffs = dets @ Vinv.T
    roots, valid = polynomial.real_roots(coeffs, max_roots=3)
    F = F1[..., None, :, :] + roots[..., :, None, None] * F2[..., None, :, :]
    return F, valid


def point_line_error_sq(F, x1, x2):
    """Squared distance of x2 to the epipolar line F x1 (F_ACRobust).

    F (..., 3, 3), x1/x2 (..., N, 2) -> (..., N).  F is normalised to unit
    Frobenius norm first (a tiny-scale F from a null vector would
    underflow the line norm); a (near-)zero F scores +inf everywhere so it
    never wins."""
    norm = torch.linalg.matrix_norm(F)[..., None, None]
    F = F / torch.clamp(norm, min=1e-30)
    l = (x1 @ F[..., :, :2].transpose(-1, -2)) + F[..., None, :, 2]
    num = l[..., 0] * x2[..., 0] + l[..., 1] * x2[..., 1] + l[..., 2]
    den = l[..., 0] ** 2 + l[..., 1] ** 2
    err = num * num / torch.clamp(den, min=1e-30)
    return torch.where(norm[..., 0] > 1e-20, err, torch.full_like(err, float("inf")))


def _epi_lines(F, x1):
    """F @ x1_h: (..., 3, 3) x (..., N, 2) -> (..., N, 3)."""
    return x1 @ F[..., :, :2].transpose(-1, -2) + F[..., None, :, 2]


def symmetric_epipolar_error_sq(F, x1, x2):
    """Sum of the squared distances to both epipolar lines
    (kernel::SymmetricEpipolarDistanceError)."""
    return point_line_error_sq(F, x1, x2) + point_line_error_sq(F.transpose(-1, -2), x2, x1)


def sampson_error_sq(F, x1, x2):
    """First-order geometric (Sampson) squared error (kernel::SampsonError)."""
    l2 = _epi_lines(F, x1)
    l1 = _epi_lines(F.transpose(-1, -2), x2)
    num = l2[..., 0] * x2[..., 0] + l2[..., 1] * x2[..., 1] + l2[..., 2]
    den = l2[..., 0] ** 2 + l2[..., 1] ** 2 + l1[..., 0] ** 2 + l1[..., 1] ** 2
    return num * num / torch.clamp(den, min=1e-30)
