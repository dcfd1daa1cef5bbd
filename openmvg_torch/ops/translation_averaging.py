"""Global translation averaging (counterpart:
openmvg_tpu/ops/translation_averaging.py; multiview/
translation_averaging_solver_softl1.cpp, _l2_chordal.cpp, and the L1
solver of global_translations_fromTij.cpp recast as IRLS weights).

Unknowns: per-pose translations t_i (x_c = R x + t) and one scale per
relative-motion group s_g, with the residual per edge
    r_e = t_j - R_ij t_i - s_g(e) t_ij
under SOFTL1 (tau = 0.01), plain L2 or IRLS-L1 weights, a one-sided pull
s_g >= 1 and the gauge t_0 = 0.  n_iterations Gauss-Newton steps with a
fixed Levenberg damping on the dense (3N + S) normal equations.

Each step's normal equations are assembled on the host in float64 with
np.add.at (a fixed order of additions for duplicate indices; index_add_
on the card adds them with atomics, in a run-dependent order) and solved
on `device` in float64.
"""

import numpy as np
import torch

SOFTL1 = "softl1"
L2 = "l2"
L1 = "l1"


def _loss_sqrt_weight(r_norm2, method, tau=0.01):
    if method == L2:
        return np.ones_like(r_norm2)
    if method == SOFTL1:
        return (1.0 + r_norm2 / (tau * tau)) ** -0.25   # sqrt of rho' = 1/sqrt(1 + s/b)
    return np.maximum(np.sqrt(r_norm2), 1e-6) ** -0.5   # L1 by IRLS


def solve_translation_averaging(n_views, edges_i, edges_j, R_rel, t_rel, method=SOFTL1,
                                n_iterations=60, tau=0.01, scale_pull=1.0, scale_group=None,
                                device="cpu"):
    """Returns (t (n_views, 3), s (S,)) as float64 numpy, t_0 = 0.

    R_rel (E, 3, 3) = R_j R_i^T, t_rel (E, 3) relative translations up to
    a positive scale (x_j = R_rel x_i + s t_rel).  scale_group (E,) maps
    each edge to a shared scale (a triplet's three edges share one);
    default one scale per edge."""
    ei = np.asarray(edges_i, np.int64)
    ej = np.asarray(edges_j, np.int64)
    Rr = np.asarray(R_rel, np.float64)
    tr = np.asarray(t_rel, np.float64)
    E, N = len(ei), n_views
    sg = np.arange(E) if scale_group is None else np.asarray(scale_group, np.int64)
    n_scales = int(sg.max()) + 1 if E else 0
    dim = 3 * N + n_scales
    eye = np.eye(3)
    ar3 = np.arange(3)
    rows_j = (3 * ej)[:, None, None] + ar3[None, :, None]
    cols_j = (3 * ej)[:, None, None] + ar3[None, None, :]
    rows_i = (3 * ei)[:, None, None] + ar3[None, :, None]
    cols_i = (3 * ei)[:, None, None] + ar3[None, None, :]
    scol = 3 * N + sg
    svar = 3 * N + np.arange(n_scales)
    RtR = np.einsum("eki,ekj->eij", Rr, Rr)
    Jt_s_j = -tr
    Jt_s_i = np.einsum("eij,ej->ei", np.swapaxes(Rr, -1, -2), tr)
    ttr = np.sum(tr * tr, -1)

    t = np.ones((N, 3))
    t[0] = 0.0
    s = np.ones(n_scales)
    lam = 1e-6
    for _ in range(n_iterations):
        r = t[ej] - np.einsum("eij,ej->ei", Rr, t[ei]) - s[sg][:, None] * tr
        w2 = _loss_sqrt_weight(np.sum(r * r, -1), method, tau) ** 2
        H = np.zeros((dim, dim))
        g = np.zeros(dim)
        np.add.at(H, (rows_j, cols_j), w2[:, None, None] * eye)
        np.add.at(H, (rows_i, cols_i), w2[:, None, None] * RtR)
        np.add.at(H, (rows_j, cols_i), -w2[:, None, None] * Rr)
        np.add.at(H, (rows_i, cols_j), -w2[:, None, None] * np.swapaxes(Rr, -1, -2))
        np.add.at(H, (rows_j[..., 0], scol[:, None]), w2[:, None] * Jt_s_j)
        np.add.at(H, (scol[:, None], cols_j[:, 0, :]), w2[:, None] * Jt_s_j)
        np.add.at(H, (rows_i[..., 0], scol[:, None]), w2[:, None] * Jt_s_i)
        np.add.at(H, (scol[:, None], cols_i[:, 0, :]), w2[:, None] * Jt_s_i)
        np.add.at(H, (scol, scol), w2 * ttr)
        np.add.at(g, rows_j[..., 0].reshape(-1), (-w2[:, None] * r).reshape(-1))
        np.add.at(g, rows_i[..., 0].reshape(-1),
                  (w2[:, None] * np.einsum("eij,ei->ej", Rr, r)).reshape(-1))
        np.add.at(g, scol, w2 * np.sum(tr * r, -1))
        # scale pull: residual max(0, 1 - s), J = -1 while s < 1
        active = (s < 1.0).astype(np.float64) * scale_pull
        H[svar, svar] += active
        g[svar] += active * (1.0 - s)
        H[ar3, ar3] += 1e8                          # gauge t_0 = 0
        H = H + lam * np.diag(np.maximum(np.diagonal(H), 1e-9))
        d = torch.linalg.solve(torch.as_tensor(H, device=device),
                               torch.as_tensor(g, device=device)).cpu().numpy()
        t = t + d[:3 * N].reshape(N, 3)
        s = s + d[3 * N:]
    return t, s
