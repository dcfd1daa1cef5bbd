"""Scene-level robust track triangulation (counterpart:
openmvg_tpu/sfm/scene_triangulation.py; openMVG
sfm/sfm_data_triangulation.cpp).

Each candidate track is triangulated from all its posed observations and
kept when it is in front of every camera, reprojects within the threshold
in every view and its widest pair of rays exceeds a minimum angle.  The
tracks go to the device as one (T, K) padded batch of observation slots
with masks: one N-view solve and one residual check for all of them.
"""

import math

import numpy as np
import torch

from openmvg_torch.models import cameras as cm
from openmvg_torch.ops.triangulation import triangulate_nview


def _triangulate_batch(Rs, ts, bearings, weights, kind, params, wi, hi, x_obs,
                       min_angle_cos, max_resid_sq):
    """(T, K, ...) padded track observations -> (X (T, 3), ok (T,))."""
    X, cheir = triangulate_nview(Rs, ts, bearings, weights=weights)
    Xc = torch.einsum("tkij,tj->tki", Rs, X) + ts
    d = cm.residual(kind, params, wi, hi, Xc, x_obs)
    res_ok = (((d * d).sum(-1) <= max_resid_sq) | (weights <= 0)).all(-1)
    rays = torch.einsum("tkji,tkj->tki", Rs, bearings)
    rays = rays / torch.clamp(torch.linalg.vector_norm(rays, dim=-1, keepdim=True), min=1e-30)
    G = torch.einsum("tki,tli->tkl", rays, rays)
    pair_ok = (weights[:, :, None] > 0) & (weights[:, None, :] > 0)
    G = torch.where(pair_ok, G, torch.ones_like(G))
    angle_ok = G.amin(dim=(-2, -1)) < min_angle_cos
    n_obs = (weights > 0).sum(-1)
    return X, cheir & res_ok & angle_ok & (n_obs >= 2)


def triangulate_tracks(scene, obs_view, obs_x, track_of_obs, n_tracks, min_angle_deg=2.0,
                       max_residual_px=4.0, max_slots=16, device="cpu",
                       dtype=torch.float64):
    """Triangulate `n_tracks` tracks from their posed observations.

    obs_view (M,), obs_x (M, 2), track_of_obs (M,) in [0, n_tracks); only
    observations of posed views.  At most max_slots observations of a
    track are used.  Returns (X (n_tracks, 3), ok (n_tracks,)) numpy."""
    if n_tracks == 0 or len(obs_view) == 0:
        return np.zeros((0, 3)), np.zeros(0, bool)
    order = np.argsort(track_of_obs, kind="stable")
    tr_s = track_of_obs[order]
    slot = np.arange(len(tr_s)) - np.searchsorted(tr_s, tr_s)
    keep = slot < max_slots
    tr_s, slot = tr_s[keep], slot[keep]
    ov = obs_view[order][keep]
    ox = np.asarray(obs_x)[order][keep]
    K = max(int(slot.max()) + 1, 2)
    T = n_tracks

    pid = scene.view_pose[ov]
    iid = scene.view_intrinsic[ov]
    R = scene.pose_R[pid]
    t = -np.einsum("nij,nj->ni", R, scene.pose_C[pid])

    def slots(vals, fill, shape, np_dtype=np.float64):
        a = np.full((T, K) + shape, fill, np_dtype)
        a[tr_s, slot] = vals
        return torch.as_tensor(a, device=device)

    def f(a):
        return a.to(dtype)

    cams = scene.cameras
    kinds = slots(np.asarray(cams.kind)[iid], cm.PINHOLE, (), np.int32)
    prs = f(slots(np.asarray(cams.params)[iid], 0.0, (cm.MAX_PARAMS,)))
    wis = f(slots(np.asarray(cams.width)[iid], 1.0, ()))
    his = f(slots(np.asarray(cams.height)[iid], 1.0, ()))
    xs = f(slots(ox, 0.0, (2,)))
    ws = f(slots(1.0, 0.0, ()))
    Rs = f(slots(R, 0.0, (3, 3)))
    Rs = torch.where(ws[..., None, None] > 0, Rs, torch.eye(3, dtype=dtype, device=device))
    ts = f(slots(t, 0.0, (3,)))
    bs = cm.bearing(kinds, prs, wis, his, xs)
    bs = torch.where(ws[..., None] > 0, bs, torch.tensor([0.0, 0.0, 1.0], dtype=dtype,
                                                          device=device))
    X, ok = _triangulate_batch(Rs, ts, bs, ws, kinds, prs, wis, his, xs,
                               math.cos(math.radians(min_angle_deg)), max_residual_px ** 2)
    return X.cpu().double().numpy(), ok.cpu().numpy()
