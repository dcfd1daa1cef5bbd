"""Port parity for structure from known poses: guided matching of every
posed pair (the batched K1 route), tracks and triangulation, openmvg_torch
against openmvg_tpu on the same scene, float64 on the CPU.  The landmark
count and the observations are equal, the points agree to 1e-8, while no
track is longer than 16 observations; past that the port checks every
observation, the reference only the first 16.
"""

import numpy as np
import pytest
import torch

from openmvg_tpu.sfm import known_poses as jkp
from openmvg_tpu.sfm.scene import rmse as jrmse
from openmvg_tpu.utils.synthetic import ring_scene
from openmvg_torch.io import from_reference
from openmvg_torch.sfm import known_poses as tkp
from openmvg_torch.sfm.scene import rmse
from tests.test_ba import scene_from_ring


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs on several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring_case(noise_px=0.0):
    """tests/test_aux_components.py::test_localization_and_known_poses: a
    6-view ring, one random descriptor per point seen alike in every view."""
    rng = np.random.default_rng(1)
    s = ring_scene(n_views=6, n_points=80, seed=1)
    point_desc = rng.integers(0, 255, size=(s.n_points, 128)).astype(np.uint8)
    feats = [np.concatenate([s.x[v] + rng.normal(scale=noise_px, size=s.x[v].shape),
                             np.ones((s.n_points, 2))], axis=1) for v in range(s.n_views)]
    return s, feats, [point_desc.copy() for _ in range(s.n_views)]


def test_known_poses_on_the_port():
    """The known-poses half of test_localization_and_known_poses on the port."""
    s, feats, descs = _ring_case()
    sc2 = from_reference(scene_from_ring(s, seed=3))
    n_before = sc2.n_landmarks
    tkp.structure_from_known_poses(sc2, feats, descs, device="cpu")
    assert sc2.n_landmarks > 0.6 * n_before
    assert rmse(sc2) < 0.2


@pytest.mark.parametrize("noise_px", [0.0, 0.5])
def test_known_poses_equal_the_reference(noise_px):
    s, feats, descs = _ring_case(noise_px)
    ref = jkp.structure_from_known_poses(scene_from_ring(s, seed=3), feats, descs)
    got = tkp.structure_from_known_poses(from_reference(scene_from_ring(s, seed=3)), feats,
                                         descs, device="cpu")
    assert got.n_landmarks == ref.n_landmarks > 0
    for f in ("obs_landmark", "obs_view", "obs_feat", "obs_valid", "X_valid"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_array_equal(got.obs_x, np.asarray(ref.obs_x))
    np.testing.assert_allclose(got.X, np.asarray(ref.X), atol=1e-8)
    np.testing.assert_allclose(rmse(got), jrmse(ref), atol=1e-8)


def test_known_poses_checks_every_observation_of_long_tracks():
    """A 20-view ring whose every point is seen 20 times; in view 19 five
    points sit 30 px off along the epipolar line of pair (18, 19), so only
    that pair's guided matching takes them into their tracks.  The
    reference triangulates and checks the first 16 observations of a track
    and keeps the rest unchecked (rmse near 2 px); the port checks every
    observation and drops those five tracks."""
    s = ring_scene(n_views=20, n_points=60, seed=1)
    assert s.visible.all()
    rng = np.random.default_rng(1)
    point_desc = rng.integers(0, 255, size=(s.n_points, 128)).astype(np.uint8)
    feats = [np.concatenate([s.x[v].copy(), np.ones((s.n_points, 2))], 1) for v in range(20)]
    descs = [point_desc.copy() for _ in range(20)]
    tsc = from_reference(scene_from_ring(s, seed=3))
    F = tkp._pair_F(tsc, 18, 19)
    for p in range(5):
        line = F @ np.r_[s.x[18][p], 1.0]
        along = np.array([line[1], -line[0]]) / np.hypot(line[0], line[1])
        feats[19][p, :2] = s.x[19][p] + 30.0 * along
    ref = jkp.structure_from_known_poses(scene_from_ring(s, seed=3), feats, descs)
    got = tkp.structure_from_known_poses(tsc, feats, descs, device="cpu")
    assert ref.n_landmarks == 60 and jrmse(ref) > 1.0
    assert got.n_landmarks == 55 and rmse(got) < 1e-6
    assert not np.isin(got.obs_feat[got.obs_view == 19], np.arange(5)).any()
