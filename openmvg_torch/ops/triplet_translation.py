"""Triplet translations and structure from known rotations, batched
(counterpart: openmvg_tpu/ops/triplet_translation.py).

Reference parity: the reference solves this minimal problem with an
L-infinity bisection LP (translations_Triplet_Solver) inside AC-RANSAC
(triplet_t_ACRansac_kernelAdaptator.hpp: logalpha0 = log10(pi),
multError = 1, MINIMUM_SAMPLES = 4) per pose triplet
(GlobalSfM_translation_averaging.cpp Estimate_T_triplet :643-860).  As in
the JAX package, with rotations known the constraints
x_hat x (R_i X_j + t_i) = 0 are linear in (t_i, X_j): each track's X_j is
eliminated through its 3x3 block and the translations are the smallest
eigenvector of the 3(V-1) x 3(V-1) reduced system (gauge t_0 = 0, unit
scale, sign by cheirality).

Every function takes leading batch dimensions (triplets, samples).  No
batched cuSOLVER call: the 3x3 blocks are inverted in closed form and the
6x6 eigenproblem runs the cyclic Jacobi of ops/linalg.py (cuSOLVER refused
large batched eigh on the H100).
"""

import math
from typing import NamedTuple

import torch

from openmvg_torch.geometry.so3 import skew
from openmvg_torch.ops import linalg, ransac


def solve_translations_known_rotations(xs, Rs, valid=None, ridge=1e-10):
    """Translations (t_0 = 0 gauge) and structure from known rotations.

    xs (..., V, m, 2) normalised image coordinates, Rs (..., V, 3, 3),
    valid (..., m) weights or None.  Returns (ts (..., V, 3), X (..., m, 3))."""
    V, m = xs.shape[-3], xs.shape[-2]
    dt, dev = xs.dtype, xs.device
    lead = torch.broadcast_shapes(xs.shape[:-3], Rs.shape[:-3])
    bear = torch.cat([xs, torch.ones(xs.shape[:-1] + (1,), dtype=dt, device=dev)], -1)
    BX = skew(bear)                                            # coefficient of t_v
    C = torch.einsum("...vmij,...vjk->...vmik", BX, Rs)        # coefficient of X_m
    nt = 3 * (V - 1)
    sel = torch.eye(V, dtype=dt, device=dev)[1:]               # t_0 = 0 gauge
    B = torch.einsum("uv,...vmij->...vmiuj", sel, BX).reshape(BX.shape[:-2] + (3, nt))
    w = torch.ones(xs.shape[:-3] + (m,), dtype=dt, device=dev) if valid is None else valid.to(dt)
    wb = w[..., None, :, None, None]
    Bf = (B * wb).expand(lead + B.shape[-4:]).movedim(-4, -3).reshape(lead + (m, 3 * V, nt))
    Cf = (C * wb).expand(lead + C.shape[-4:]).movedim(-4, -3).reshape(lead + (m, 3 * V, 3))
    CtC = torch.einsum("...mri,...mrj->...mij", Cf, Cf) + ridge * torch.eye(3, dtype=dt, device=dev)
    CtB = torch.einsum("...mri,...mrj->...mij", Cf, Bf)
    G = -linalg.inv_sym3(CtC) @ CtB                            # X_m = G_m t
    BCG = Bf + Cf @ G
    S = torch.einsum("...mri,...mrj->...ij", BCG, BCG)
    t = linalg.eigh(S)[1][..., 0]
    ts = torch.cat([torch.zeros(lead + (1, 3), dtype=dt, device=dev),
                    t.reshape(lead + (V - 1, 3))], -2)
    X = torch.einsum("...mij,...j->...mi", G, t)
    # cheirality: the majority of (weighted) depths positive, else flip
    depth = torch.einsum("...vij,...mj->...vmi", Rs, X)[..., 2] + ts[..., :, None, 2]
    vote = (torch.sign(depth) * w[..., None, :]).sum((-2, -1))
    sgn = torch.where(vote >= 0, 1.0, -1.0).to(dt)
    return ts * sgn[..., None, None], X * sgn[..., None, None]


def _max_reproj_error(ts, Rs, xs, eps=1e-12):
    """TrifocalTensorModel::Error: each track triangulated from the three
    cameras by its 3x3 normal equations (adjugate), then its largest
    squared reprojection error in normalised coordinates (+inf behind a
    camera).  ts (..., 3, 3), Rs (..., 3, 3, 3), xs (..., 3, N, 2) ->
    (..., N); every product is elementwise over the track axis."""
    def e(a):                       # a per-camera scalar against the track axis
        return a[..., None]

    bx = [xs[..., v, :, 0] for v in range(3)]
    by = [xs[..., v, :, 1] for v in range(3)]
    M = [[0.0] * 3 for _ in range(3)]
    rhs = [0.0] * 3
    for v in range(3):
        R = Rs[..., v, :, :]
        t = ts[..., v, :]
        C = ([by[v] * e(R[..., 2, a]) - e(R[..., 1, a]) for a in range(3)],
             [e(R[..., 0, a]) - bx[v] * e(R[..., 2, a]) for a in range(3)],
             [bx[v] * e(R[..., 1, a]) - by[v] * e(R[..., 0, a]) for a in range(3)])
        d = (by[v] * e(t[..., 2]) - e(t[..., 1]),
             e(t[..., 0]) - bx[v] * e(t[..., 2]),
             bx[v] * e(t[..., 1]) - by[v] * e(t[..., 0]))
        for a in range(3):
            for b in range(a, 3):
                M[a][b] = M[a][b] + sum(C[i][a] * C[i][b] for i in range(3))
            rhs[a] = rhs[a] - sum(C[i][a] * d[i] for i in range(3))
    for a in range(3):
        for b in range(a):
            M[a][b] = M[b][a]
    c00 = M[1][1] * M[2][2] - M[1][2] * M[2][1]
    c01 = M[0][2] * M[2][1] - M[0][1] * M[2][2]
    c02 = M[0][1] * M[1][2] - M[0][2] * M[1][1]
    c11 = M[0][0] * M[2][2] - M[0][2] * M[2][0]
    c12 = M[0][2] * M[1][0] - M[0][0] * M[1][2]
    c22 = M[0][0] * M[1][1] - M[0][1] * M[1][0]
    det = M[0][0] * c00 + M[0][1] * (M[1][2] * M[2][0] - M[1][0] * M[2][2]) \
        + M[0][2] * (M[1][0] * M[2][1] - M[1][1] * M[2][0])
    det = torch.where(det.abs() < eps, torch.full_like(det, eps), det)
    X = [(c00 * rhs[0] + c01 * rhs[1] + c02 * rhs[2]) / det,
         (c01 * rhs[0] + c11 * rhs[1] + c12 * rhs[2]) / det,
         (c02 * rhs[0] + c12 * rhs[1] + c22 * rhs[2]) / det]
    err = None
    for v in range(3):
        R = Rs[..., v, :, :]
        t = ts[..., v, :]
        p = [e(R[..., k, 0]) * X[0] + e(R[..., k, 1]) * X[1] + e(R[..., k, 2]) * X[2]
             + e(t[..., k]) for k in range(3)]
        z = p[2]
        zs = torch.where(z.abs() < eps, torch.full_like(z, eps), z)
        ev = (p[0] / zs - bx[v]) ** 2 + (p[1] / zs - by[v]) ** 2
        ev = torch.where(z > 0, ev, torch.full_like(ev, math.inf))
        err = ev if err is None else torch.maximum(err, ev)
    return err


class TripletTranslationResult(NamedTuple):
    ts: torch.Tensor             # (B, 3, 3) translations, t_0 = 0, unit scale
    inliers: torch.Tensor        # (B, N) bool
    nfa: torch.Tensor            # (B,)
    threshold_sq: torch.Tensor   # (B,) squared threshold, normalised coordinates
    found: torch.Tensor          # (B,)


def triplet_translation_acransac_batch(generators, xs, Rs, valid, n_samples=320,
                                       precision_norm=math.inf, gumbel=None):
    """AC-RANSAC over tracks for B triplets at once.

    xs (B, 3, N, 2) normalised coordinates, Rs (B, 3, 3, 3) known
    world -> camera rotations, valid (B, N); precision_norm (B,) or a
    scalar upper bound of the residual in normalised units (the reference
    passes 4 px / the smallest focal).  generators: B torch.Generators, or
    None with a (B, n_draws, N) gumbel table.  The model found is refit on
    all its inliers, and the refit is kept when it has at least as many."""
    dt, dev = xs.dtype, xs.device
    R1 = Rs[:, None]

    def fit(sub):
        pts = sub[0].transpose(-3, -2)                      # (B, S, 3, 4, 2)
        ts, X = solve_translations_known_rotations(pts, R1)
        depth = torch.einsum("...vij,...mj->...vmi", R1, X)[..., 2] + ts[..., :, None, 2]
        ok = (depth > 0).all(-1).all(-1) & torch.isfinite(ts).all(-1).all(-1)
        return ts[:, :, None], ok[:, :, None]

    def err(ts, data):
        return _max_reproj_error(ts, R1, data[0].transpose(1, 2)[:, None])

    prec = torch.as_tensor(precision_norm, dtype=dt, device=dev) ** 2
    res = ransac.ac_ransac(generators, fit, err, (xs.transpose(1, 2),), valid, min_samples=4,
                           logalpha0=math.log10(math.pi), mult_error=1.0,
                           n_samples=n_samples, precision_sq=prec, gumbel=gumbel)
    ts_ref, _ = solve_translations_known_rotations(xs, Rs, valid=res.inliers.to(dt))
    e = _max_reproj_error(ts_ref, Rs, xs)
    inl_ref = (e <= res.threshold_sq[:, None]) & valid
    refined_ok = inl_ref.sum(-1) >= res.inliers.sum(-1)
    ts = torch.where(refined_ok[:, None, None], ts_ref, res.model)
    inl = torch.where(refined_ok[:, None], inl_ref, res.inliers) & res.found[:, None]
    return TripletTranslationResult(ts=ts, inliers=inl, nfa=res.nfa,
                                    threshold_sq=res.threshold_sq, found=res.found)


def triplet_translation_acransac(generator, xs, Rs, valid, n_samples=320,
                                 precision_norm=math.inf, gumbel=None):
    """One triplet (no batch dimension); gumbel (n_draws, N) or None."""
    res = triplet_translation_acransac_batch(
        [generator], xs[None], Rs[None], valid[None], n_samples=n_samples,
        precision_norm=precision_norm, gumbel=None if gumbel is None else gumbel[None])
    return TripletTranslationResult(*[x[0] for x in res])
