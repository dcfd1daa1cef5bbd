"""Global rotation averaging: L2 spectral and L1 (IRLS or LAD-ADMM), the
spanning-tree initialisation and triplet rejection (counterpart:
openmvg_tpu/ops/rotation_averaging.py; multiview/rotation_averaging_l2
.cpp L2RotationAveraging, rotation_averaging_l1.cpp GlobalRotationsRobust,
GlobalSfM_rotation_averaging.hpp:26 TripletRotationRejection).

Convention: R_ij = R_j R_i^T (world -> camera, x_j = R_ij x_i), as
openMVG's RelativeRotation.

The block matrices are assembled on the host in float64 with np.add.at,
which adds duplicate indices in a fixed order (index_add_ on the card adds
them with atomics, in a run-dependent order).  With a few hundred views
they are a few hundred to a few thousand rows.  The one dense
decomposition per call (eigh of the Laplacian, or a solve per IRLS round)
runs on `device`.
"""

from typing import List, Tuple

import numpy as np
import torch

from openmvg_torch.geometry import so3
from openmvg_torch.ops import linalg


def _blocks(e):
    """Row and column index grids (E, 3, 3) of the 3x3 blocks at e."""
    r = (3 * np.asarray(e, np.int64))[:, None, None] + np.arange(3)[None, :, None]
    c = (3 * np.asarray(e, np.int64))[:, None, None] + np.arange(3)[None, None, :]
    return r, c


def _laplacian(n_views, ei, ej, R_rel, w):
    """L_ii += w I, L_jj += w I, L_ij -= w R_ij^T, L_ji -= w R_ij."""
    L = np.zeros((3 * n_views, 3 * n_views))
    rows_i, cols_i = _blocks(ei)
    rows_j, cols_j = _blocks(ej)
    wI = w[:, None, None] * np.eye(3)
    Rw = w[:, None, None] * R_rel
    np.add.at(L, (rows_i, cols_i), wI)
    np.add.at(L, (rows_j, cols_j), wI)
    np.add.at(L, (rows_i, cols_j), -np.swapaxes(Rw, -1, -2))
    np.add.at(L, (rows_j, cols_i), -Rw)
    return L, rows_i, rows_j


def _host(a):
    return a.detach().cpu().numpy().astype(np.float64) if torch.is_tensor(a) \
        else np.asarray(a, np.float64)


def _weights(weights, E):
    return np.ones(E) if weights is None else _host(weights)


def l2_rotation_averaging(n_views, edges_i, edges_j, R_rel, weights=None, device="cpu"):
    """Spectral L2 averaging.  edges_i/j (E,) view indices in
    [0, n_views), R_rel (E, 3, 3) = R_j R_i^T, weights (E,) or None.
    Returns (n_views, 3, 3) float64 rotations on `device`, gauge R_0 = I."""
    ei, ej = np.asarray(edges_i), np.asarray(edges_j)
    L, _, _ = _laplacian(n_views, ei, ej, _host(R_rel), _weights(weights, len(ei)))
    _, V = torch.linalg.eigh(torch.as_tensor(L, device=device))
    # each 3-row block of the three smallest eigenvectors is X_i = R_i Q for
    # one common Q; view 0 fixes the gauge
    X = V[:, :3].reshape(n_views, 3, 3)
    Q_inv = linalg.inv(X[0] + 1e-12 * torch.eye(3, dtype=X.dtype, device=X.device))
    return so3.project_to_so3(X @ Q_inv)


def spanning_tree_rotations(n_views, edges_i, edges_j, R_rel, weights=None):
    """Global rotations composed along a maximum-weight spanning tree from
    the first edge's first view (host; the L1 initialisation of the
    reference).  Returns (n_views, 3, 3) numpy."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree

    ei, ej = np.asarray(edges_i), np.asarray(edges_j)
    Rr = _host(R_rel)
    w = _weights(weights, len(ei))
    g = coo_matrix((1.0 / (w + 1e-9), (ei, ej)), shape=(n_views, n_views))
    mst = minimum_spanning_tree(g).tocoo()
    lookup, adj = {}, {}
    for a, b, R in zip(ei, ej, Rr):
        lookup[(int(a), int(b))] = R
        lookup[(int(b), int(a))] = R.T
    for a, b in zip(mst.row, mst.col):
        adj.setdefault(int(a), []).append(int(b))
        adj.setdefault(int(b), []).append(int(a))
    R_glob = np.tile(np.eye(3), (n_views, 1, 1))
    root = int(ei[0])
    seen, stack = {root}, [root]
    while stack:
        u = stack.pop()
        for v in adj.get(u, []):
            if v in seen:
                continue
            seen.add(v)
            R_glob[v] = lookup[(u, v)] @ R_glob[u]   # R_v = R_uv R_u
            stack.append(v)
    return R_glob


def l1_rotation_averaging(n_views, edges_i, edges_j, R_rel, weights=None, n_irls=16,
                          init=None, solver="irls", device="cpu"):
    """L1 refinement of an initialisation (default: the L2 solution).

    Linearised residual per edge r_e + R_ij^T d_j - d_i with
    r_e = log(R_ij^T R_j R_i^T), gauge d_0 = 0, n_irls rounds.
    solver "irls" re-weights the dense 3N normal equations by
    1 / max(|r|, 1e-3); "admm" solves each round's linearised
    min sum |r + J d| with LAD-ADMM.  Returns (n_views, 3, 3) float64 on
    `device`."""
    from openmvg_torch.ops.l1_admm import solve_lad

    if solver not in ("irls", "admm"):
        raise ValueError(f"unknown solver {solver}")
    ei, ej = np.asarray(edges_i), np.asarray(edges_j)
    base_w = _weights(weights, len(ei))
    if init is None:
        init = l2_rotation_averaging(n_views, ei, ej, R_rel, weights, device)
    R = torch.as_tensor(_host(init), device=device)
    Rr_h = _host(R_rel)
    Rr = torch.as_tensor(Rr_h, device=device)
    ei_t, ej_t = torch.as_tensor(ei, device=device), torch.as_tensor(ej, device=device)
    N, E = n_views, len(ei)
    rows_i, cols_i = _blocks(ei)
    rows_j, cols_j = _blocks(ej)

    def residuals(R):
        return so3.logmap(Rr.transpose(-1, -2) @ R[ej_t] @ R[ei_t].transpose(-1, -2))

    for _ in range(n_irls):
        r = _host(residuals(R))
        if solver == "admm":
            J = np.zeros((3 * E, 3 * N))
            rows = (3 * np.arange(E))[:, None, None] + np.arange(3)[None, :, None]
            wcol = base_w[:, None, None]
            np.add.at(J, (rows, cols_i), -np.eye(3) * wcol)
            np.add.at(J, (rows, cols_j), np.swapaxes(Rr_h, -1, -2) * wcol)
            J[:, :3] = 0.0                        # gauge: d_0 = 0
            d = solve_lad(torch.as_tensor(J, device=device),
                          torch.as_tensor(-(base_w[:, None] * r).reshape(-1), device=device),
                          iters=200).reshape(N, 3)
            d[0] = 0.0
        else:
            w = base_w / np.maximum(np.linalg.norm(r, axis=-1), 1e-3)
            # left perturbation R_k <- exp(d_k) R_k: J_i = -I, J_j = R_ij^T
            L, ri, rj = _laplacian(N, ei, ej, Rr_h, w)
            b = np.zeros(3 * N)
            np.add.at(b, ri[..., 0].reshape(-1), (w[:, None] * r).reshape(-1))
            np.add.at(b, rj[..., 0].reshape(-1),
                      (-np.einsum("eij,ej->ei", w[:, None, None] * Rr_h, r)).reshape(-1))
            L[np.arange(3), np.arange(3)] += 1e6  # gauge: pin view 0
            L += 1e-9 * np.eye(3 * N)
            d = torch.linalg.solve(torch.as_tensor(L, device=device),
                                   torch.as_tensor(b, device=device)).reshape(N, 3)
        R = so3.expmap(d) @ R
    return R


def triplet_rotation_rejection(pairs: List[Tuple[int, int]], R_rel_map, max_angle_deg=5.0):
    """Keep the pairs supported by at least one triplet whose composed
    rotation R_ki R_jk R_ij is within max_angle_deg of the identity.

    pairs: list of (i, j); R_rel_map: {(i, j): R_ij = R_j R_i^T} (numpy).
    Returns (kept pairs set, valid triplets list), in the reference's
    order."""
    from openmvg_torch.utils.graph import list_triplets

    triplets = list_triplets(pairs)
    if not triplets:
        return set(), []

    def rel(a, b):
        if (a, b) in R_rel_map:
            return np.asarray(R_rel_map[(a, b)])
        return np.asarray(R_rel_map[(b, a)]).T

    Rij = torch.as_tensor(np.stack([rel(i, j) for (i, j, k) in triplets]), dtype=torch.float64)
    Rjk = torch.as_tensor(np.stack([rel(j, k) for (i, j, k) in triplets]), dtype=torch.float64)
    Rki = torch.as_tensor(np.stack([rel(k, i) for (i, j, k) in triplets]), dtype=torch.float64)
    good = (so3.rotation_angle_deg(Rki @ Rjk @ Rij) < max_angle_deg).numpy()
    valid = [t for t, g in zip(triplets, good) if g]
    kept = set()
    for (i, j, k) in valid:
        kept.add((i, j) if (i, j) in R_rel_map else (j, i))
        kept.add((j, k) if (j, k) in R_rel_map else (k, j))
        kept.add((i, k) if (i, k) in R_rel_map else (k, i))
    return kept, valid
