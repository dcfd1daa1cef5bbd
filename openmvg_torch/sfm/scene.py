"""The Scene record — openMVG's SfM_Data as dense host arrays
(counterpart: openmvg_tpu/sfm/scene.py).

Views, intrinsics and poses are struct-of-arrays keyed by dense ids with
validity masks; observations are one flat table.  Host side it is numpy;
device code receives the tensors it needs.
"""

import dataclasses
from typing import List, Optional

import numpy as np

from openmvg_torch.models import cameras as cm
from openmvg_torch.utils import hostmath


def _empty_cameras():
    return cm.Cameras(kind=np.zeros(0, np.int32), width=np.zeros(0),
                      height=np.zeros(0), params=np.zeros((0, cm.MAX_PARAMS)))


@dataclasses.dataclass
class Scene:
    root_path: str = ""
    view_filename: List[str] = dataclasses.field(default_factory=list)
    view_intrinsic: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    view_pose: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    view_wh: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 2), np.int32))
    # GPS priors: weight <= 0 means no prior (sfm_view_priors.hpp)
    prior_center: Optional[np.ndarray] = None       # (V, 3)
    prior_center_weight: Optional[np.ndarray] = None  # (V, 3)
    cameras: cm.Cameras = dataclasses.field(default_factory=_empty_cameras)
    # poses; world->cam x_c = R (X - C)
    pose_valid: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, bool))
    pose_R: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 3, 3)))
    pose_C: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 3)))
    # structure: landmarks + flat observation table
    X: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 3)))
    X_valid: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, bool))
    obs_landmark: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    obs_view: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    obs_x: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 2)))
    obs_feat: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    obs_valid: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, bool))
    # control points: same landmark layout, separate table
    cp_X: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 3)))
    cp_obs_landmark: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    cp_obs_view: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    cp_obs_x: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 2)))
    cp_obs_feat: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))

    @property
    def n_views(self):
        return len(self.view_intrinsic)

    @property
    def n_intrinsics(self):
        return len(self.cameras.kind)

    @property
    def n_poses(self):
        return len(self.pose_valid)

    @property
    def n_landmarks(self):
        return int(np.sum(self.X_valid))

    @property
    def n_observations(self):
        return int(np.sum(self.obs_valid))

    def valid_view_poses(self):
        """View ids whose pose is estimated."""
        pid = self.view_pose
        ok = (pid >= 0) & (pid < self.n_poses)
        out = np.zeros(self.n_views, bool)
        out[ok] = self.pose_valid[pid[ok]]
        return np.nonzero(out)[0]

    def obs_arrays_for_ba(self):
        """Per-observation (pose id, intrinsic id, landmark id, pixel) of the
        valid observations on valid poses and landmarks."""
        ok = self.obs_valid.copy()
        pid = self.view_pose[self.obs_view]
        ok &= self.pose_valid[np.clip(pid, 0, max(self.n_poses - 1, 0))] & (pid >= 0)
        ok &= self.X_valid[self.obs_landmark]
        sel = np.nonzero(ok)[0]
        return dict(obs_idx=sel, pose_id=pid[sel],
                    intr_id=self.view_intrinsic[self.obs_view[sel]],
                    landmark_id=self.obs_landmark[sel], x=self.obs_x[sel])

    def compact_structure(self):
        """Drop invalid landmarks and observations and renumber the
        landmarks densely."""
        keep_l = np.nonzero(self.X_valid)[0]
        remap = np.full(len(self.X_valid), -1, np.int32)
        remap[keep_l] = np.arange(len(keep_l), dtype=np.int32)
        keep_o = self.obs_valid & (remap[self.obs_landmark] >= 0)
        self.X = self.X[keep_l]
        self.X_valid = np.ones(len(keep_l), bool)
        self.obs_landmark = remap[self.obs_landmark[keep_o]]
        self.obs_view = self.obs_view[keep_o]
        self.obs_x = self.obs_x[keep_o]
        self.obs_feat = self.obs_feat[keep_o]
        self.obs_valid = np.ones(int(keep_o.sum()), bool)
        return self


def group_shared_intrinsics(scene: Scene):
    """Merge identical intrinsics and remap the views
    (sfm_data_utils.cpp GroupSharedIntrinsics)."""
    cams = scene.cameras
    keys = {}
    remap = np.zeros(scene.n_intrinsics, np.int32)
    kept = []
    for i in range(scene.n_intrinsics):
        key = (int(cams.kind[i]), float(cams.width[i]), float(cams.height[i]),
               tuple(np.round(np.asarray(cams.params)[i], 12)))
        if key not in keys:
            keys[key] = len(kept)
            kept.append(i)
        remap[i] = keys[key]
    if len(kept) == scene.n_intrinsics:
        return scene
    scene.cameras = cm.Cameras(kind=np.asarray(cams.kind)[kept],
                               width=np.asarray(cams.width)[kept],
                               height=np.asarray(cams.height)[kept],
                               params=np.asarray(cams.params)[kept])
    ok = scene.view_intrinsic >= 0
    scene.view_intrinsic[ok] = remap[scene.view_intrinsic[ok]]
    return scene


def reprojection_residuals(scene: Scene):
    """Residuals (M, 2) of every valid observation, in float64 on the host,
    and the obs_arrays_for_ba info they belong to."""
    info = scene.obs_arrays_for_ba()
    if len(info["obs_idx"]) == 0:
        return np.zeros((0, 2)), info
    R = scene.pose_R[info["pose_id"]]
    C = scene.pose_C[info["pose_id"]]
    Xc = np.einsum("nij,nj->ni", R, scene.X[info["landmark_id"]] - C)
    cams = scene.cameras
    iid = info["intr_id"]
    r = hostmath.residual_np(np.asarray(cams.kind)[iid], np.asarray(cams.params)[iid],
                             np.asarray(cams.width)[iid], np.asarray(cams.height)[iid], Xc,
                             info["x"])
    return r, info


def rmse(scene: Scene):
    """Root-mean-square reprojection error over the valid observations."""
    r, _ = reprojection_residuals(scene)
    if len(r) == 0:
        return float("inf")
    return float(np.sqrt(np.mean(np.sum(r * r, axis=1))))
