"""Scene outlier filters and stability erasure (counterpart:
openmvg_tpu/sfm/filters.py; openMVG sfm/sfm_data_filters.cpp).

  remove_outliers_pixel_residual   observations beyond a pixel residual,
                                   then landmarks left with too few
  remove_outliers_angle_error      landmarks whose widest pair of rays is
                                   under a minimum angle
  erase_unstable_poses_and_observations   iterate pose / landmark support
                                   erasure to a fixed point
  bad_track_rejector               the incremental engine's cleanup
  depth_cleaning                   observations beyond k times their
                                   view's median depth (STELLAR's pods,
                                   `points-filter`)

Vectorised numpy over the flat observation table; they mutate the
Scene's masks in place between bundle adjustments.
"""

import numpy as np
import torch

from openmvg_torch.models import cameras as cm
from openmvg_torch.sfm.scene import Scene, reprojection_residuals


def remove_outliers_pixel_residual(scene: Scene, threshold_px=4.0, min_track_length=2) -> int:
    r, info = reprojection_residuals(scene)
    if len(r) == 0:
        return 0
    bad = np.linalg.norm(r, axis=1) > threshold_px
    scene.obs_valid[info["obs_idx"][bad]] = False
    _drop_short_tracks(scene, min_track_length)
    return int(bad.sum())


def _drop_short_tracks(scene: Scene, min_track_length):
    counts = np.bincount(scene.obs_landmark[scene.obs_valid], minlength=len(scene.X_valid))
    short = counts < min_track_length
    scene.X_valid &= ~short
    scene.obs_valid &= ~short[scene.obs_landmark]


def _posed_obs(scene: Scene):
    ok = scene.obs_valid & scene.X_valid[scene.obs_landmark]
    pid = scene.view_pose[scene.obs_view]
    ok &= (pid >= 0) & scene.pose_valid[np.clip(pid, 0, max(scene.n_poses - 1, 0))]
    return np.nonzero(ok)[0], pid


def remove_outliers_angle_error(scene: Scene, min_angle_deg=2.0) -> int:
    """Drop landmarks whose maximum pairwise observation-ray angle is below
    min_angle_deg.  Exact: landmarks are bucketed by power-of-two track
    length and each bucket's ray Gram matrices are checked in chunks
    (float32 rays, as the reference)."""
    idx, pid = _posed_obs(scene)
    if len(idx) == 0:
        return 0
    iid = scene.view_intrinsic[scene.obs_view[idx]]
    cams = scene.cameras

    def t(a):
        return torch.as_tensor(np.asarray(a))

    b = cm.bearing(t(np.asarray(cams.kind)[iid]), t(np.asarray(cams.params, np.float64)[iid]),
                   t(np.asarray(cams.width, np.float64)[iid]),
                   t(np.asarray(cams.height, np.float64)[iid]), t(scene.obs_x[idx])).numpy()
    rays = np.einsum("nji,nj->ni", scene.pose_R[pid[idx]], b)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    rays = rays.astype(np.float32)

    lm = scene.obs_landmark[idx]
    L = len(scene.X_valid)
    order = np.argsort(lm, kind="stable")
    counts = np.bincount(lm, minlength=L)
    starts = np.zeros(L + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    cos_min = np.float32(np.cos(np.radians(min_angle_deg)))
    bad = np.zeros(L, bool)
    done = counts < 2
    D = 2
    while D <= 64:
        sel = np.nonzero(~done & (counts <= D))[0]
        done[sel] = True
        if len(sel):
            col = np.arange(D)[None, :]
            rowid = starts[sel, None] + np.minimum(col, counts[sel, None] - 1)
            chunk = max(1, (1 << 22) // (D * D))
            for lo in range(0, len(sel), chunk):
                r = rays[order[rowid[lo:lo + chunk]]]
                G = np.einsum("cid,cjd->cij", r, r)
                bad[sel[lo:lo + chunk]] = G.min(axis=(1, 2)) > cos_min
        D *= 2
    for l in np.nonzero(~done)[0]:  # tracks of more than 64 observations
        r = rays[order[starts[l]:starts[l + 1]]]
        bad[l] = (r @ r.T).min() > cos_min
    bad &= scene.X_valid
    removed = int(bad.sum())
    if removed:
        scene.X_valid &= ~bad
        scene.obs_valid &= scene.X_valid[scene.obs_landmark]
    return removed


def erase_unstable_poses_and_observations(scene: Scene, min_points_per_pose=6,
                                          min_points_per_landmark=2) -> bool:
    """Drop poses with fewer than min_points_per_pose observations, their
    observations, and landmarks left short, until nothing changes."""
    changed_any = False
    while True:
        changed = False
        ok = scene.obs_valid & scene.X_valid[scene.obs_landmark]
        pid = scene.view_pose[scene.obs_view]
        pid_c = np.clip(pid, 0, max(scene.n_poses - 1, 0))
        pid_ok = (pid >= 0) & scene.pose_valid[pid_c]
        counts = np.bincount(pid[ok & pid_ok], minlength=scene.n_poses)
        weak = scene.pose_valid & (counts < min_points_per_pose)
        if weak.any():
            scene.pose_valid &= ~weak
            changed = True
        pid_ok = (pid >= 0) & scene.pose_valid[pid_c]
        if (scene.obs_valid & ~pid_ok).any():
            scene.obs_valid &= pid_ok
            changed = True
        before = scene.X_valid.copy()
        _drop_short_tracks(scene, min_points_per_landmark)
        changed |= bool((before != scene.X_valid).any())
        changed_any |= changed
        if not changed:
            return changed_any


def bad_track_rejector(scene: Scene, precision_px=4.0, count_threshold=50,
                       min_angle_deg=2.0) -> bool:
    """sequential_SfM.cpp badTrackRejector: True when more than
    count_threshold outliers were removed (BA should run again)."""
    n1 = remove_outliers_pixel_residual(scene, precision_px, 2)
    n2 = remove_outliers_angle_error(scene, min_angle_deg)
    return (n1 + n2) > count_threshold


def depth_cleaning(scene: Scene, k_factor=5.2, min_points_per_pose=12, min_track_length=2):
    """DepthCleaning (sfm_data_filters.cpp:391-469): drop the observations
    whose camera depth is not positive or not under k_factor times their
    view's median positive depth, then erase unstable poses and landmarks.
    Returns the smallest median depth over the views."""
    idx, pid = _posed_obs(scene)
    if len(idx) == 0:
        return float("inf")
    R = scene.pose_R[pid[idx]]
    depth = np.einsum("nj,nj->n", R[:, 2, :],
                      scene.X[scene.obs_landmark[idx]] - scene.pose_C[pid[idx]])
    views = scene.obs_view[idx]
    thr = {}
    min_median = float("inf")
    for v in np.unique(views):
        dv = depth[(views == v) & (depth > 0)]
        if len(dv):
            m = float(np.median(dv))
            thr[int(v)] = k_factor * m
            min_median = min(min_median, m)
    t = np.array([thr.get(int(v), -1.0) for v in views])
    keep = (depth > 0) & (t > 0) & (depth < t)
    scene.obs_valid[idx[~keep]] = False
    erase_unstable_poses_and_observations(scene, min_points_per_pose, min_track_length)
    return min_median
