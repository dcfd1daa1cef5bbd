"""GPS-prior registration of a reconstruction (counterpart:
openmvg_tpu/sfm/gps_registration.py).

Reference parity: sfm_data_BA_ceres.cpp:181-239 (a robust LMedS
similarity between the pose centres and their priors) and
Geodesy/registration_to_exif_gps_position.cpp (rigid + scale registration
of a reconstruction onto EXIF GPS positions in ECEF).  The minimal 3-point
fits and their residuals run as one batch on the device
(ops/ransac.lmeds); the scene is transformed on the host.
"""

import numpy as np
import torch

from openmvg_torch.geometry.similarity import Similarity, find_rts
from openmvg_torch.ops import ransac


def fit_similarity_lmeds(src, dst, generator=None, n_samples=256, idx=None, device="cuda"):
    """Robust similarity src -> dst, (N, 3) each, by LMedS over 3-point
    fits drawn from `generator` (a torch.Generator on `device`, seeded 0
    when None), or over the (n_samples, 3) sample table idx.  Returns a
    Similarity of float64 CPU tensors."""
    a = torch.as_tensor(np.asarray(src, np.float64), device=device)
    b = torch.as_tensor(np.asarray(dst, np.float64), device=device)
    n = a.shape[0]
    if n < 3:
        raise ValueError("need >= 3 correspondences")
    if n == 3:
        sim = find_rts(a, b)
        return Similarity(*(x.cpu() for x in sim))
    if generator is None and idx is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def fit(sub):
        sim = find_rts(*sub)
        model = torch.cat([sim.scale[:, None], sim.R.reshape(-1, 9), sim.t], -1)
        return model[:, None], torch.ones(model.shape[0], 1, dtype=torch.bool,
                                          device=model.device)

    def err(m, data):
        x, y = data
        R = m[:, 1:10].reshape(-1, 3, 3)
        pred = m[:, 0, None, None] * torch.einsum("rij,nj->rni", R, x) + m[:, None, 10:13]
        return ((pred - y[None]) ** 2).sum(-1)

    valid = torch.ones(n, dtype=torch.bool, device=device)
    model, _ = ransac.lmeds(generator, fit, err, (a, b), valid, 3, n_samples=n_samples,
                            idx=idx)
    model = model.cpu()
    return Similarity(scale=model[0], R=model[1:10].reshape(3, 3), t=model[10:13])


def apply_similarity_to_scene(scene, sim):
    """Poses and structure transformed in place (sfm_data_transform.cpp
    ApplySimilarity): C' = s R C + t, R_pose' = R_pose R^T, X' = s R X + t."""
    s = float(np.asarray(sim.scale))
    R = np.asarray(sim.R, np.float64)
    t = np.asarray(sim.t, np.float64)
    valid = scene.pose_valid
    scene.pose_C[valid] = s * scene.pose_C[valid] @ R.T + t
    scene.pose_R[valid] = np.einsum("nij,kj->nik", scene.pose_R[valid], R)
    if len(scene.X):
        scene.X[:] = s * scene.X @ R.T + t
    return scene


def register_to_gps(scene, use_priors_from_scene=True, positions=None, device="cuda"):
    """The scene registered onto GPS positions (its priors unless
    `positions` (n_views, 3) is given); returns (scene, similarity)."""
    if positions is None:
        if scene.prior_center is None:
            raise ValueError("scene has no GPS priors")
        views = np.nonzero(np.any(scene.prior_center_weight > 0, axis=1))[0]
        positions = scene.prior_center[views]
    else:
        views = np.arange(len(positions))
    pids = scene.view_pose[views]
    ok = (pids >= 0) & scene.pose_valid[np.clip(pids, 0, max(scene.n_poses - 1, 0))]
    sim = fit_similarity_lmeds(scene.pose_C[pids[ok]], np.asarray(positions)[ok],
                               device=device)
    return apply_similarity_to_scene(scene, sim), sim
