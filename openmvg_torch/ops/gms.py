"""GMS (Grid-based Motion Statistics) match filtering (counterpart:
openmvg_tpu/ops/gms.py, numpy on the host in both packages).

Reference parity: robust_estimation/gms_filter.hpp:27 — divide both images
into G x G cells; true matches cluster, so a match is kept when the number
of supporting matches in its 3x3 cell-pair neighborhood exceeds
alpha * sqrt(average support) (Bian et al., CVPR 2017).  Single-scale,
no-rotation variant (the reference's default grid mode), fully vectorized.
"""

import numpy as np


def gms_filter(xa, xb, wh_a, wh_b, grid=20, alpha=6.0):
    """xa, xb (N, 2) matched pixel positions; returns keep mask (N,).

    Runs the 4 half-cell grid offsets of the original GMS and keeps a
    match accepted by any of them (cell-boundary robustness)."""
    xa = np.asarray(xa)
    xb = np.asarray(xb)
    n = len(xa)
    if n == 0:
        return np.zeros(0, bool)
    keep = np.zeros(n, bool)
    half_a = (wh_a[0] / grid / 2.0, wh_a[1] / grid / 2.0)
    half_b = (wh_b[0] / grid / 2.0, wh_b[1] / grid / 2.0)
    for sx, sy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        off_a = np.array([sx * half_a[0], sy * half_a[1]])
        off_b = np.array([sx * half_b[0], sy * half_b[1]])
        keep |= _gms_once(xa + off_a, xb + off_b, wh_a, wh_b, grid, alpha)
    return keep


def _gms_once(xa, xb, wh_a, wh_b, grid, alpha):
    n = len(xa)
    ca = _cell(xa, wh_a, grid)
    cb = _cell(xb, wh_b, grid)
    votes = np.zeros((grid * grid, grid * grid), np.int32)
    np.add.at(votes, (ca, cb), 1)

    # neighborhood aggregation: for the (cell_a, cell_b) of each match, sum
    # votes over the 9 aligned neighbor cell-pairs
    ya, xa_c = divmod(ca, grid)
    yb, xb_c = divmod(cb, grid)
    score = np.zeros(n, np.float64)
    support_cells = np.zeros(n, np.float64)
    cell_tot = votes.sum(axis=1)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            na_y, na_x = ya + dy, xa_c + dx
            nb_y, nb_x = yb + dy, xb_c + dx
            ok = ((na_y >= 0) & (na_y < grid) & (na_x >= 0) & (na_x < grid)
                  & (nb_y >= 0) & (nb_y < grid) & (nb_x >= 0) & (nb_x < grid))
            ia = np.clip(na_y, 0, grid - 1) * grid + np.clip(na_x, 0, grid - 1)
            ib = np.clip(nb_y, 0, grid - 1) * grid + np.clip(nb_x, 0, grid - 1)
            score += np.where(ok, votes[ia, ib], 0)
            support_cells += np.where(ok, cell_tot[ia], 0)
    score -= 1  # exclude the match itself
    mean_support = support_cells / 9.0
    thresh = alpha * np.sqrt(np.maximum(mean_support / 9.0, 1e-9))
    return score > thresh


def _cell(x, wh, grid):
    cx = np.clip((x[:, 0] / wh[0] * grid).astype(int), 0, grid - 1)
    cy = np.clip((x[:, 1] / wh[1] * grid).astype(int), 0, grid - 1)
    return cy * grid + cx


def gms_filter_matches(matches, features, wh_of_view, grid=20, alpha=6.0):
    """Apply GMS per pair over a PairWiseMatches dict."""
    out = {}
    for (i, j), m in matches.items():
        m = np.asarray(m)
        keep = gms_filter(features[i][m[:, 0], :2], features[j][m[:, 1], :2],
                          wh_of_view(i), wh_of_view(j), grid, alpha)
        if keep.sum() >= 2:
            out[(i, j)] = m[keep]
    return out
