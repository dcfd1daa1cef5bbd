"""Localisation of new images in an existing reconstruction (counterpart:
openmvg_tpu/sfm/localization.py).

Reference parity: sfm/pipelines/localization/SfM_Localizer.cpp (:109
Localize, AC-RANSAC resection over 2D-3D matches; :345 RefinePose, a
pose-only bundle adjustment) and
SfM_Localizer_Single_3DTrackObservation_Database.cpp (one database row per
landmark observation, matched against the query's descriptors);
software/Localization/main_SfM_Localization.cpp.

On the device: the query-by-database L2 distances (the plain product
ops/two_nn.l2_distance_matrix, in blocks of queries that fit the card),
their 8 nearest rows (ties to the lower row, lax.top_k's rule), P3P
AC-RANSAC (the angular kernel for SPHERICAL cameras) and the pose-only
refinement, whose camera sums go through kernel K2.
"""

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from openmvg_torch.models import cameras as cm
from openmvg_torch.ops.two_nn import l2_distance_matrix
from openmvg_torch.sfm import ba, robust

BLOCK_BYTES = 1 << 30   # one block of the (queries, database) distance matrix


class LandmarkDB(NamedTuple):
    """Descriptor database over the reconstructed landmarks."""

    desc: np.ndarray       # (M, D) one descriptor per landmark observation
    landmark: np.ndarray   # (M,) landmark id of each row
    X: np.ndarray          # (L, 3) landmark positions


def build_landmark_database(scene, descs_per_view) -> LandmarkDB:
    """One row per (landmark, observation) with a descriptor
    (SfM_Localizer_Single_3DTrackObservation_Database::Init)."""
    rows_d, rows_l = [], []
    ok = scene.obs_valid & scene.X_valid[scene.obs_landmark]
    for idx in np.nonzero(ok)[0]:
        v = int(scene.obs_view[idx])
        f = int(scene.obs_feat[idx])
        d = descs_per_view[v]
        if d is None or f >= len(d):
            continue
        rows_d.append(d[f])
        rows_l.append(int(scene.obs_landmark[idx]))
    if not rows_d:
        return LandmarkDB(np.zeros((0, 128), np.uint8), np.zeros(0, np.int64), scene.X)
    return LandmarkDB(np.stack(rows_d), np.asarray(rows_l), scene.X)


class LocalizationResult(NamedTuple):
    found: bool
    R: Optional[np.ndarray]
    C: Optional[np.ndarray]
    n_inliers: int
    threshold_px: float
    inliers: Optional[np.ndarray] = None   # over match_query's rows


def nearest_rows(query, database, k=8):
    """The k nearest database rows of every query row by squared L2, the
    lower row first on ties: (distances (Q, k) float32, rows (Q, k) int64),
    on the tensors' device.  The (Q, M) distances are formed one block of
    queries at a time.  Integer (uint8) distances are exact, and their
    ties are broken by a unique key distance * M + row."""
    Q, M = query.shape[0], database.shape[0]
    exact = query.dtype == torch.uint8 and database.dtype == torch.uint8
    step = max(1, BLOCK_BYTES // (8 * max(M, 1)))
    ds, ids = [], []
    for s in range(0, Q, step):
        d = l2_distance_matrix(query[s:s + step], database)
        if exact:
            key = d.to(torch.int64) * M + torch.arange(M, device=d.device)
            key, idx = torch.topk(key, k, dim=-1, largest=False, sorted=True)
            ds.append((key // M).to(torch.float32))
        else:
            dk, idx = torch.topk(d, k, dim=-1, largest=False, sorted=True)
            ds.append(dk)
        ids.append(idx)
    return torch.cat(ds), torch.cat(ids)


def match_query(db: LandmarkDB, query_feats, query_descs, ratio=0.8, device="cuda"):
    """The query's 2D-3D matches: each descriptor's nearest database row,
    kept when it passes the ratio against the best row of a different
    landmark (the database holds several near-identical descriptors of a
    landmark, one per observation, which would defeat a plain 2-NN ratio
    test).  Returns (x2d (n, 2), X3d (n, 3)) float64, or None when too
    few are left."""
    if len(db.desc) < 10 or len(query_descs) < 10:
        return None
    k = min(8, len(db.desc))
    d_sorted, idx = nearest_rows(torch.as_tensor(np.asarray(query_descs), device=device),
                                 torch.as_tensor(np.asarray(db.desc), device=device), k)
    d_sorted, idx = d_sorted.cpu().numpy(), idx.cpu().numpy()
    lm_of = db.landmark[idx]
    best_lm = lm_of[:, 0]
    diff = lm_of != best_lm[:, None]
    d2 = np.where(diff.any(axis=1),
                  np.take_along_axis(d_sorted, np.argmax(diff, axis=1)[:, None], axis=1)[:, 0],
                  np.inf)
    qi = np.nonzero(d_sorted[:, 0] < (ratio * ratio) * d2)[0]
    if len(qi) < 8:
        return None
    return (np.asarray(query_feats, np.float64)[qi, :2],
            np.asarray(db.X, np.float64)[best_lm[qi]])


def localize_image(db: LandmarkDB, query_feats, query_descs, K, w, h, ratio=0.8,
                   n_samples=1024, refine=True, seed=0, kind=cm.PINHOLE, disto_params=None,
                   device="cuda") -> LocalizationResult:
    """match_query, then AC-RANSAC P3P (adaptive budget, rounds of 256
    samples) and the pose-only refinement.  The random draws come from a
    torch.Generator seeded `seed`."""
    m = match_query(db, query_feats, query_descs, ratio, device)
    if m is None:
        return LocalizationResult(False, None, None, 0, 0.0)
    x2d, X3d = m
    params = np.zeros(cm.MAX_PARAMS)
    params[0] = K[0, 0]
    params[1:3] = K[:2, 2]
    if disto_params is not None:
        params[3:3 + len(disto_params)] = disto_params

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    n = len(x2d)
    b = cm.bearing(torch.full((n,), int(kind), dtype=torch.int32, device=device),
                   t(np.tile(params, (n, 1))), t(np.full(n, w)), t(np.full(n, h)), t(x2d))
    valid = torch.ones(n, dtype=torch.bool, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if int(kind) == cm.SPHERICAL:
        out = robust.robust_resection_angular(gen, b, t(X3d), valid, n_samples=n_samples)
    else:
        # the adaptive budget (robust_estimator_ACRansac.hpp:326-489): easy
        # queries stop after a few rounds, hard ones spend all n_samples
        round_size = min(256, n_samples)
        out = robust.robust_resection_p3p_adaptive_single(
            gen, b, t(x2d), t(X3d), t(K), valid, t(w), t(h), round_size=round_size,
            max_rounds=max(1, -(-n_samples // round_size)))
    R, tt = out.model
    inl = out.inliers.cpu().numpy()
    if not bool(out.found) or inl.sum() < 8:
        return LocalizationResult(False, None, None, int(inl.sum()), 0.0)
    R = R.cpu().numpy()
    C = -R.T @ tt.cpu().numpy()
    if refine:
        prob = pose_problem(R, C, params, kind, w, h, x2d[inl], X3d[inl], device)
        R, C = _refine_pose(prob)
    return LocalizationResult(True, R, C, int(inl.sum()),
                              math.sqrt(float(out.threshold_sq)), inl)


def pose_problem(R, C, params, kind, w, h, x2d, X3d, device):
    """The float64 pose-only bundle adjustment problem of an inlier 2D-3D
    set: one pose free, the intrinsic and the points fixed."""
    from openmvg_torch.utils import hostmath

    n = len(x2d)
    fields = dict(
        obs_pose=np.zeros(n), obs_intr=np.zeros(n), obs_point=np.arange(n), obs_x=x2d,
        obs_w=np.ones(n), rotvec=hostmath.logmap_np(R[None]), t=(-R @ C)[None],
        intr_kind=np.full(1, int(kind)), intr_wh=np.asarray([[w, h]], np.float64),
        intr_params=params[None], X=X3d, mask_pose=np.ones((1, 6)),
        mask_intr=np.zeros((1, 8)), mask_X=np.zeros(n), prior_C=np.zeros((1, 3)),
        prior_w=np.zeros((1, 3)))
    return ba.problem_from_reference(fields, dtype=torch.float64, device=device)


def _refine_pose(prob):
    """SfM_Localizer::RefinePose: ten LM iterations of the pose-only
    problem; the camera sums launch K2 on the card.  Returns (R, C)."""
    from openmvg_torch.utils import hostmath

    prob, _, _ = ba.adjust(prob, ba.BAConfig(max_iterations=10))
    R2 = hostmath.expmap_np(prob.rotvec[0].cpu().numpy()[None])[0]
    return R2, -R2.T @ prob.t[0].cpu().numpy()
