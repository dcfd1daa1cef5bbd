"""The GLOBAL engine of the port at a large scene (counterpart:
tests/test_big_scene.py::test_global_sfm_500_views_1m_obs), on the card:
OMT_BIG_VIEWS views (200 by default, 500 for the reference's full size) of
the reference's ring scene, at least 4,000 observations a view, 0.3 px
noise; at least 95% of the poses, rmse < 1 px, the trajectory within 2% of
the ring radius after 7-DoF alignment, inside 1,800 s.  Marked slow and
cuda: the whole-engine run at this size is work for the card."""

import os
import time

import numpy as np
import pytest
import torch

from openmvg_torch.geometry.similarity import find_rts
from openmvg_torch.models import cameras as cm
from openmvg_torch.sfm import ba
from openmvg_torch.sfm import pipeline_global as G
from openmvg_torch.sfm.scene import Scene, rmse
from openmvg_torch.utils.synthetic import ring_scene


def _ring_data(s, noise_px, seed):
    """tests/test_incremental.py's scene_and_data in the port's types (it
    imports nothing of the reference, so it runs where JAX is not
    installed): no poses, features the projections plus noise, matches
    between each view and its next three on the co-visible points."""
    rng = np.random.default_rng(seed)
    V = s.n_views
    sc = Scene()
    sc.view_filename = [f"v{i}.jpg" for i in range(V)]
    sc.view_intrinsic = np.zeros(V, np.int32)
    sc.view_pose = np.arange(V, dtype=np.int32)
    sc.view_wh = np.tile([[1000, 1000]], (V, 1)).astype(np.int32)
    sc.cameras = cm.make_pinhole(1000, 1000, s.K[0, 0, 0], s.K[0, 0, 2], s.K[0, 1, 2])
    sc.pose_valid = np.zeros(V, bool)
    sc.pose_R = np.tile(np.eye(3), (V, 1, 1))
    sc.pose_C = np.zeros((V, 3))
    feats = [s.x[v] + rng.normal(scale=noise_px, size=s.x[v].shape) for v in range(V)]
    matches = {}
    for i in range(V):
        for j in range(i + 1, min(i + 4, V)):
            vis = np.nonzero(s.visible[i] & s.visible[j])[0]
            matches[(i, j)] = np.stack([vis, vis], axis=1)
    return sc, feats, matches


@pytest.mark.slow
@pytest.mark.cuda
def test_global_sfm_big_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n_views = int(os.environ.get("OMT_BIG_VIEWS", "200"))
    s = ring_scene(n_views=n_views, n_points=8 * n_views, seed=0)
    sc, feats, matches = _ring_data(s, noise_px=0.3, seed=1)
    n_obs = sum(len(m) for m in matches.values())
    assert n_obs >= 4000 * n_views, n_obs
    t0 = time.perf_counter()
    G.global_sfm(sc, feats, matches, G.GlobalConfig(ransac_samples=256, ba_iterations=10,
                                                    refine_intrinsics=ba.ADJUST_NONE),
                 seed=0, device="cuda")
    wall = time.perf_counter() - t0
    n_poses = int(sc.pose_valid.sum())
    got = np.nonzero(sc.pose_valid)[0]
    est, gt = torch.as_tensor(sc.pose_C[got])[None], torch.as_tensor(s.C[got])[None]
    aligned = find_rts(est, gt).apply(est)[0].numpy()
    ate = float(np.sqrt(np.mean(np.sum((aligned - s.C[got]) ** 2, axis=1))))
    print(f"GLOBAL {n_views} views, {n_obs} matches: {n_poses} poses, rmse "
          f"{rmse(sc):.4f} px, ATE {ate:.5f}, {wall:.1f} s on {torch.cuda.get_device_name(0)}")
    assert n_poses >= 0.95 * n_views, n_poses
    assert rmse(sc) < 1.0
    assert ate < 0.02 * 2.0  # 2% of the ring radius
    assert wall < 1800, f"GLOBAL {n_views}-view run took {wall:.0f} s"
