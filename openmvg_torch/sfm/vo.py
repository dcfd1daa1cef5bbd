"""Monocular visual odometry (counterpart: openmvg_tpu/sfm/vo.py).

Reference parity: software/VO/Monocular_VO.hpp:75 — frame-to-frame
feature tracking (FAST corners + KLT), a track container with landmark
ids, and the relative pose of the tracked correspondences from the
essential matrix, up to scale.  The reference's demonstration pipeline,
not a production SLAM system.

Detection and tracking run on `device` (ops/fast.py); the relative pose is
the port's 5-point AC-RANSAC (sfm/robust.py::robust_relative_pose) on one
torch.Generator seeded once, where the reference splits a JAX key per
frame.  The bookkeeping of tracks stays on the host, as in the reference.
"""

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from openmvg_torch.ops import fast
from openmvg_torch.sfm import robust


class VOState(NamedTuple):
    pts: np.ndarray          # (N, 2) active track positions
    ids: np.ndarray          # (N,) track ids
    next_id: int
    poses: List[np.ndarray]  # accumulated [R|C] world poses (up to scale)


class MonocularVO:
    """Frame-to-frame VO: track FAST corners with KLT, re-detect when the
    track count drops, estimate the relative pose with 5-point AC-RANSAC."""

    def __init__(self, K, min_tracks=300, fast_threshold=0.06, seed=0, device="cuda"):
        self.K = np.asarray(K, np.float64)
        self.min_tracks = min_tracks
        self.fast_threshold = fast_threshold
        self.device = torch.device(device)
        self.prev_img = None
        self.state: Optional[VOState] = None
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.trajectory = [np.zeros(3)]
        self.R_cur = np.eye(3)
        self.C_cur = np.zeros(3)

    def _detect(self, img, existing=None, max_corners=1024):
        xy, _, ok = fast.fast_detect(img, threshold=self.fast_threshold,
                                     max_corners=max_corners)
        xy = xy[ok].cpu().numpy()
        if existing is not None and len(existing):
            # no new track on top of a live one
            d = np.linalg.norm(xy[:, None] - existing[None], axis=2)
            xy = xy[d.min(axis=1) > 8.0]
        return xy

    def process(self, img):
        img = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
        if self.prev_img is None:
            pts = self._detect(img)
            self.state = VOState(pts=pts, ids=np.arange(len(pts)), next_id=len(pts),
                                 poses=[np.eye(4)])
            self.prev_img = img
            return True

        st = self.state
        new_pts, ok = fast.klt_track(self.prev_img, img,
                                     torch.as_tensor(st.pts, dtype=torch.float32,
                                                     device=self.device))
        new_pts, ok = new_pts.cpu().numpy(), ok.cpu().numpy()
        p0, p1, ids = st.pts[ok], new_pts[ok], st.ids[ok]

        moved = np.linalg.norm(p1 - p0, axis=1).mean() if len(p1) else 0.0
        if len(p0) >= 8 and moved > 0.5:
            def t(a):
                return torch.as_tensor(np.asarray(a, np.float64), device=self.device)

            info = robust.robust_relative_pose(
                self.generator, t(self._bearings(p0)), t(self._bearings(p1)), t(p0), t(p1),
                t(self.K), t(self.K), torch.ones(len(p0), dtype=torch.bool, device=self.device),
                float(self.K[0, 2] * 2), float(self.K[1, 2] * 2), n_samples=256)
            if bool(info.found):
                R_rel = info.R.cpu().numpy()
                t_rel = info.t.cpu().numpy()
                # compose (unit-scale translation)
                C_rel = -R_rel.T @ t_rel
                self.C_cur = self.C_cur + self.R_cur.T @ C_rel
                self.R_cur = R_rel @ self.R_cur
                self.trajectory.append(self.C_cur.copy())

        # refill the tracks
        next_id = st.next_id
        if len(p1) < self.min_tracks:
            fresh = self._detect(img, existing=p1)[:max(self.min_tracks - len(p1), 0)]
            if len(fresh):
                p1 = np.concatenate([p1, fresh])
                ids = np.concatenate([ids, np.arange(next_id, next_id + len(fresh))])
                next_id += len(fresh)
        self.state = VOState(pts=p1, ids=ids, next_id=next_id, poses=st.poses)
        self.prev_img = img
        return True

    def _bearings(self, pts):
        p = (pts - self.K[:2, 2]) / np.array([self.K[0, 0], self.K[1, 1]])
        b = np.concatenate([p, np.ones((len(p), 1))], axis=1)
        return b / np.linalg.norm(b, axis=1, keepdims=True)
