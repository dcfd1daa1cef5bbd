"""The port's localisation (openmvg_torch/sfm/localization.py) against the
reference's on the same inputs: a 12-view ring of 300 points whose views
hold noisy copies of one descriptor per point, and query features and
descriptors made directly (no SIFT): the projections of the points into a
camera between two ring views, 0.3 px noise, 25% of them with random
descriptors.  The landmark databases are equal; both localise the query
(their random draws differ) with >= 90% of inliers in common and centres
within 1e-3 of each other and of the truth; likewise a SPHERICAL query."""

import numpy as np
import pytest
import torch

from openmvg_tpu.models import cameras as jcm
from openmvg_tpu.sfm import localization as jloc
from openmvg_tpu.utils.synthetic import _look_at, ring_scene
from openmvg_torch.io import from_reference
from openmvg_torch.sfm import localization as tloc
from openmvg_torch.utils.synthetic import project_spherical
from tests.test_ba import scene_from_ring

N_POINTS = 300


@pytest.fixture(scope="module")
def world():
    s = ring_scene(n_views=12, n_points=N_POINTS, seed=0)
    sc = scene_from_ring(s, seed=1)
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (N_POINTS, 128))
    descs = [np.clip(base + rng.integers(-6, 7, base.shape), 0, 255).astype(np.uint8)
             for _ in range(12)]
    theta = 2 * np.pi * 3.5 / 12
    C = np.array([2.0 * np.cos(theta), 0.2 * np.sin(2 * theta), 2.0 * np.sin(theta)])
    R = _look_at(C, [0.0, 0.0, 0.0])
    qdesc = np.clip(base + rng.integers(-6, 7, base.shape), 0, 255).astype(np.uint8)
    out = rng.random(N_POINTS) < 0.25
    qdesc[out] = rng.integers(0, 256, (int(out.sum()), 128))
    return s, sc, descs, R, C, qdesc, rng


def _feats(xy):
    return np.concatenate([xy, np.ones((len(xy), 1)), np.zeros((len(xy), 1))], 1)


def test_landmark_database_equal(world):
    _, sc, descs, *_ = world
    a = jloc.build_landmark_database(sc, descs)
    b = tloc.build_landmark_database(from_reference(sc), descs)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_nearest_rows_ties_to_lower_row():
    q = torch.zeros((2, 128), dtype=torch.uint8)
    db = torch.zeros((6, 128), dtype=torch.uint8)
    db[[1, 4]] = 3
    d, idx = tloc.nearest_rows(q, db, 5)
    assert idx.tolist() == [[0, 2, 3, 5, 1]] * 2
    assert d[0].tolist() == [0, 0, 0, 0, 9 * 128]


def _compare(ref, got, C_true):
    assert ref.found and got.found
    np.testing.assert_allclose(got.C, ref.C, atol=1e-3)
    np.testing.assert_allclose(got.C, C_true, atol=1e-3)
    assert got.n_inliers >= 0.9 * ref.n_inliers and ref.n_inliers >= 0.9 * got.n_inliers


def test_localize_pinhole(world):
    s, sc, descs, R, C, qdesc, rng = world
    K = s.K[0]
    Xc = (s.X - C) @ R.T
    x = Xc[:, :2] / Xc[:, 2:3] * K[0, 0] + K[:2, 2] + rng.normal(0, 0.3, (N_POINTS, 2))
    db_j = jloc.build_landmark_database(sc, descs)
    db_t = tloc.build_landmark_database(from_reference(sc), descs)
    ref = jloc.localize_image(db_j, _feats(x), qdesc, K, 1000.0, 1000.0)
    got = tloc.localize_image(db_t, _feats(x), qdesc, K, 1000.0, 1000.0, device="cpu")
    _compare(ref, got, C)
    assert abs(got.threshold_px - ref.threshold_px) < 0.5 * max(ref.threshold_px, 1.0)


def test_localize_spherical(world):
    s, sc, descs, R, C, qdesc, rng = world
    w, h = 2048.0, 1024.0
    sc_sph = from_reference(sc)
    x = project_spherical(np.repeat(R[None], N_POINTS, 0), np.repeat(C[None], N_POINTS, 0),
                          s.X, w, h) + rng.normal(0, 0.3, (N_POINTS, 2))
    db_j = jloc.build_landmark_database(sc, descs)
    db_t = tloc.build_landmark_database(sc_sph, descs)
    K = np.eye(3)
    ref = jloc.localize_image(db_j, _feats(x), qdesc, K, w, h, kind=jcm.SPHERICAL)
    got = tloc.localize_image(db_t, _feats(x), qdesc, K, w, h, kind=jcm.SPHERICAL,
                              device="cpu")
    _compare(ref, got, C)


def test_localize_too_few_matches(world):
    s, sc, descs, R, C, qdesc, rng = world
    db_t = tloc.build_landmark_database(from_reference(sc), descs)
    junk = rng.integers(0, 256, (50, 128)).astype(np.uint8)
    res = tloc.localize_image(db_t, _feats(rng.uniform(0, 1000, (50, 2))), junk, s.K[0],
                              1000.0, 1000.0, device="cpu")
    assert not res.found and res.C is None
