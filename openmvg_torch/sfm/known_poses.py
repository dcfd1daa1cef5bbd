"""Structure from known poses: guided epipolar matching and robust
triangulation (counterpart: openmvg_tpu/sfm/known_poses.py).

Reference parity: sfm/pipelines/structure_from_known_poses/
structure_estimator.cpp (guided matching under the epipolar geometry the
poses imply, track fusion, robust N-view triangulation),
robust_estimation/guided_matching.hpp; main_ComputeStructureFromKnownPoses.cpp.

Every observation of a track is triangulated and checked against the
threshold.  The reference uses and checks at most 16 a track and keeps the
rest unchecked; on a 100-view ring of 1024^2 views, where wrong guided
matches between far views join two tracks, that rule left a reprojection
rmse of 27.3 px (NVIDIA H100).  The two agree whenever no track is longer
than 16.

The reference matches one pair at a time.  The port takes the 2-NN of all
the pairs of a call over all their features in batched K1 launches (one
per MAX_PAIRS pairs on the card, ops/matching.py::match_descriptor_lists),
then gates every match on its pair's F by the point-to-line distance in
one float64 device call.  The geometric filter's guided matching (-r)
takes the same route with the F of each kept pair.
"""

from typing import Dict, List, Tuple

import numpy as np
import torch

from openmvg_torch.models import cameras as cm
from openmvg_torch.ops import fundamental, matching
from openmvg_torch.sfm.scene import Scene
from openmvg_torch.sfm.scene_triangulation import triangulate_tracks
from openmvg_torch.sfm.tracks import build_tracks


def _pair_F(scene, va, vb):
    """F between two posed views from their K, R and C."""
    K_all = cm.K_matrix_np(np.asarray(scene.cameras.params, np.float64))
    Ka = K_all[scene.view_intrinsic[va]]
    Kb = K_all[scene.view_intrinsic[vb]]
    pa, pb = scene.view_pose[va], scene.view_pose[vb]
    R = scene.pose_R[pb] @ scene.pose_R[pa].T
    t = scene.pose_R[pb] @ (scene.pose_C[pa] - scene.pose_C[pb])
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    return np.linalg.inv(Kb).T @ (tx @ R) @ np.linalg.inv(Ka)


def guided_matching_batch(features, descs, pairs, Fs, thresholds_px, ratio=0.8,
                          device="cuda"):
    """Descriptor matches of every pair (i, j) of `pairs` over all the
    features of both views (2-NN, ratio, dedupe), kept where the point-to-
    line distance to F x lies within the pair's threshold
    (guided_matching.hpp).  features / descs: per-view lists; Fs (P, 3, 3);
    thresholds_px scalar or (P,).  Returns a list of (M, 2) int64."""
    P = len(pairs)
    if P == 0:
        return []
    thr_sq = np.broadcast_to(np.asarray(thresholds_px, np.float64), (P,)) ** 2
    putative = matching.match_descriptor_lists(descs, pairs, ratio, device)
    ms = [putative.get((int(i), int(j)), np.zeros((0, 2), np.int64)) for i, j in pairs]
    sizes = [len(m) for m in ms]
    if not sum(sizes):
        return ms
    pid = np.repeat(np.arange(P), sizes)
    xa = np.concatenate([features[i][m[:, 0], :2] for (i, _), m in zip(pairs, ms)])
    xb = np.concatenate([features[j][m[:, 1], :2] for (_, j), m in zip(pairs, ms)])

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    err = fundamental.point_line_error_sq(t(np.asarray(Fs))[pid], t(xa)[:, None],
                                          t(xb)[:, None])[:, 0]
    keep = (err <= t(thr_sq)[pid]).cpu().numpy()
    out, ofs = [], 0
    for m, n in zip(ms, sizes):
        out.append(m[keep[ofs:ofs + n]].astype(np.int64))
        ofs += n
    return out


def guided_matching_pair(scene, va, vb, feats_a, feats_b, desc_a, desc_b,
                         epipolar_threshold_px=4.0, ratio=0.8, F=None, device="cuda"):
    """One pair through guided_matching_batch.  F defaults to the
    pose-derived fundamental; pass one to guide with an estimated model
    (GeometricFilter -r)."""
    if F is None:
        F = _pair_F(scene, va, vb)
    return guided_matching_batch([feats_a, feats_b], [desc_a, desc_b], [(0, 1)],
                                 np.asarray(F)[None], epipolar_threshold_px, ratio,
                                 device)[0]


def posed_views(scene: Scene) -> List[int]:
    """The views whose pose is set and valid, in order."""
    return [v for v in range(scene.n_views)
            if scene.view_pose[v] >= 0 and scene.pose_valid[scene.view_pose[v]]]


def structure_from_known_poses(scene: Scene, features: List[np.ndarray],
                               descs: List[np.ndarray],
                               pairs: List[Tuple[int, int]] = None,
                               epipolar_threshold_px=4.0,
                               triangulation_threshold_px=4.0,
                               min_angle_deg=2.0, ratio=0.8, device="cuda"):
    """Structure from the scene's poses; replaces its structure in place.
    Every posed pair (or `pairs`) is guided-matched in batched K1 launches,
    the matches fused into tracks and each track triangulated on `device`."""
    posed = posed_views(scene)
    if pairs is None:
        pairs = [(i, j) for ii, i in enumerate(posed) for j in posed[ii + 1:]]
    Fs = np.stack([_pair_F(scene, i, j) for i, j in pairs]) if pairs else np.zeros((0, 3, 3))
    pw: Dict[Tuple[int, int], np.ndarray] = {}
    for (i, j), m in zip(pairs, guided_matching_batch(features, descs, pairs, Fs,
                                                       epipolar_threshold_px, ratio, device)):
        if len(m) >= 2:
            pw[(i, j)] = m
    tracks = build_tracks(pw, min_length=2)
    if tracks.n_tracks == 0:
        return scene
    obs_xy = np.zeros((len(tracks.track_id), 2))
    for v in posed:
        sel = tracks.view_id == v
        obs_xy[sel] = features[v][tracks.feat_id[sel], :2]
    # every observation of a track goes into its solve and its residual
    # check (the reference stops at 16 and keeps the rest unchecked)
    X, ok = triangulate_tracks(scene, tracks.view_id, obs_xy, tracks.track_id,
                               tracks.n_tracks, min_angle_deg, triangulation_threshold_px,
                               max_slots=int(tracks.lengths().max()), device=device)
    good = np.nonzero(ok)[0]
    remap = np.full(tracks.n_tracks, -1, np.int64)
    remap[good] = np.arange(len(good))
    keep_obs = remap[tracks.track_id] >= 0
    scene.X = X[good]
    scene.X_valid = np.ones(len(good), bool)
    scene.obs_landmark = remap[tracks.track_id[keep_obs]].astype(np.int32)
    scene.obs_view = tracks.view_id[keep_obs]
    scene.obs_x = obs_xy[keep_obs]
    scene.obs_feat = tracks.feat_id[keep_obs]
    scene.obs_valid = np.ones(int(keep_obs.sum()), bool)
    return scene
