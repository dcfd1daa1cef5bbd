"""Small batched dense solvers in plain tensor ops.

The reference calls jnp.linalg.{eigh, svd, solve, inv} on tiny matrices
(3x3 to 10x10) batched over thousands of samples, points or poses.  On
the H100, cuSOLVER refused such a batched eigh (CUSOLVER_STATUS_INVALID_VALUE,
tens of thousands of 9x9 matrices), so the port keeps these out of
cuSOLVER: cyclic Jacobi for symmetric eigenproblems, a 3x3 SVD built on
it, and Gauss-Jordan elimination with partial pivoting for solves and
inverses.  Each is a fixed sequence of elementwise tensor ops, so results
are the same run to run.
"""

import torch


def det3(M):
    """Cofactor determinant of (..., 3, 3)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def inv_sym3(A):
    """Adjugate inverse of symmetric (..., 3, 3) blocks (the LM-damped point
    blocks of the bundle adjuster, the point blocks of the triplet solver);
    a determinant below 1e-30 in magnitude is held at +-1e-30."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    tiny = torch.full_like(det, 1e-30)
    det = torch.where(det.abs() < 1e-30, torch.where(det < 0, -tiny, tiny), det)
    rows = torch.stack([torch.stack([c00, c01, c02], -1), torch.stack([c01, c11, c12], -1),
                        torch.stack([c02, c12, c22], -1)], -2)
    return rows / det[..., None, None]


def solve(A, B):
    """Solve A X = B for (..., n, n) A and (..., n, m) or (..., n) B by
    Gauss-Jordan elimination with partial (row) pivoting."""
    vec = B.dim() == A.dim() - 1
    if vec:
        B = B[..., None]
    lead = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    n, m = A.shape[-1], B.shape[-1]
    M = torch.cat([A.expand(lead + (n, n)), B.expand(lead + (n, m))], -1)
    M = M.reshape(-1, n, n + m).clone()
    b = torch.arange(M.shape[0], device=A.device)
    for k in range(n):
        piv = k + torch.argmax(M[:, k:, k].abs(), dim=-1)
        rows = M[b, piv].clone()
        M[b, piv] = M[:, k].clone()
        M[:, k] = rows
        M[:, k] = M[:, k] / M[:, k, k:k + 1]
        f = M[:, :, k].clone()
        f[:, k] = 0
        M = M - f[:, :, None] * M[:, None, k]
    X = M[:, :, n:].reshape(lead + (n, m))
    return X[..., 0] if vec else X


def inv(A):
    """(..., n, n) inverse by Gauss-Jordan elimination."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    return solve(A, eye.expand(A.shape))


def eigh(A, sweeps=10):
    """Cyclic Jacobi eigendecomposition of symmetric (..., n, n) A.

    Returns (eigenvalues (..., n) ascending, eigenvectors (..., n, n) as
    columns), the contract of torch.linalg.eigh.  Ten sweeps bring 3x3 and
    4x4 matrices to float64 rounding; each rotation zeroes one
    off-diagonal pair with the stable tangent of Golub & Van Loan 8.5."""
    n = A.shape[-1]
    lead = A.shape[:-2]
    A = A.reshape(-1, n, n).clone()
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    tiny = torch.finfo(A.dtype).tiny
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                apq = A[:, p, q]
                app = A[:, p, p]
                aqq = A[:, q, q]
                nz = apq.abs() > tiny
                theta = (aqq - app) / torch.where(nz, 2.0 * apq, torch.ones_like(apq))
                sgn = torch.where(theta >= 0, 1.0, -1.0).to(A.dtype)
                t = sgn / (theta.abs() + torch.sqrt(theta * theta + 1.0))
                t = torch.where(nz, t, torch.zeros_like(t))
                c = 1.0 / torch.sqrt(t * t + 1.0)
                s = t * c
                cs, ss = c[:, None], s[:, None]
                colp, colq = A[:, :, p].clone(), A[:, :, q].clone()
                A[:, :, p] = cs * colp - ss * colq
                A[:, :, q] = ss * colp + cs * colq
                rowp, rowq = A[:, p, :].clone(), A[:, q, :].clone()
                A[:, p, :] = cs * rowp - ss * rowq
                A[:, q, :] = ss * rowp + cs * rowq
                vp, vq = V[:, :, p].clone(), V[:, :, q].clone()
                V[:, :, p] = cs * vp - ss * vq
                V[:, :, q] = ss * vp + cs * vq
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    w, order = torch.sort(w, dim=-1, stable=True)
    V = torch.gather(V, -1, order[:, None, :].expand(V.shape))
    return w.reshape(lead + (n,)), V.reshape(lead + (n, n))


def smallest_eigvec(A, sweeps=10):
    """Eigenvector of the smallest eigenvalue of symmetric (..., n, n)."""
    return eigh(A, sweeps)[1][..., 0]


def svd3(M):
    """SVD of (..., 3, 3) matrices: (U, S (..., 3) descending, Vt).

    V comes from the Jacobi eigenvectors of M^T M; S_i = |M v_i| and
    u_i = M v_i / S_i for the two largest, u_3 = u_1 x u_2 with the sign
    of M v_3 (either sign when S_3 = 0, as for an essential matrix)."""
    w, V = eigh(M.transpose(-1, -2) @ M)
    V = V.flip(-1)                                   # descending
    MV = M @ V
    S = torch.linalg.vector_norm(MV, dim=-2)
    tiny = torch.finfo(M.dtype).tiny
    u1 = MV[..., :, 0] / torch.clamp(S[..., 0:1], min=tiny)
    u2 = MV[..., :, 1] - (u1 * MV[..., :, 1]).sum(-1, keepdim=True) * u1
    u2 = u2 / torch.clamp(torch.linalg.vector_norm(u2, dim=-1, keepdim=True), min=tiny)
    u3 = torch.cross(u1, u2, dim=-1)
    sgn = torch.where((u3 * MV[..., :, 2]).sum(-1) < 0, -1.0, 1.0).to(M.dtype)
    U = torch.stack([u1, u2, u3 * sgn[..., None]], dim=-1)
    return U, S, V.transpose(-1, -2)
