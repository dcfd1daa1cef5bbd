"""The port's geometry helpers of the tools slice against the reference's,
float64 on the CPU, within 1e-9: the robust plane (max consensus with the
reference's sample table carried across), the convex hull, frusta,
ecef_to_lla and lla_to_utm, align_poses_rts, the 6-point DLT, krt_from_P,
the upright 2-point solver, preconditioner_from_points, and the Sampson
and symmetric epipolar errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmvg_tpu.geometry import convex_hull as jhull
from openmvg_tpu.geometry import frustum as jfr
from openmvg_tpu.geometry import geodesy as jgeo
from openmvg_tpu.geometry import plane as jplane
from openmvg_tpu.geometry import similarity as jsim
from openmvg_tpu.ops import conditioning as jcond
from openmvg_tpu.ops import fundamental as jfund
from openmvg_tpu.ops import ransac as jransac
from openmvg_tpu.ops import resection as jres
from openmvg_tpu.utils.synthetic import ring_scene
from openmvg_torch.geometry import convex_hull as thull
from openmvg_torch.geometry import frustum as tfr
from openmvg_torch.geometry import geodesy as tgeo
from openmvg_torch.geometry import plane as tplane
from openmvg_torch.geometry import similarity as tsim
from openmvg_torch.io import from_reference
from openmvg_torch.ops import conditioning as tcond
from openmvg_torch.ops import fundamental as tfund
from openmvg_torch.ops import resection as tres
from tests.test_ba import scene_from_ring

TOL = 1e-9


def T(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * max(1.0, np.abs(b).max()))


def _plane_points():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-1, 1, size=(80, 2))
    inl = np.column_stack([xy, 2.0 + rng.normal(0, 1e-3, 80)])
    return np.concatenate([inl, rng.uniform(-5, 5, size=(20, 3))])


@pytest.mark.parametrize("angular,thr,seed", [(False, 0.01, 0), (True, 0.02, 1)])
def test_plane_max_consensus_same_draws(angular, thr, seed):
    pts = _plane_points()
    key = jax.random.PRNGKey(seed)
    jp, jm, js = jplane.fit_plane_max_consensus(key, pts, threshold=thr, angular=angular)
    idx = np.asarray(jransac.draw_samples(key, 256, 3, jnp.ones(len(pts))))
    tp, tm, ts = tplane.fit_plane_max_consensus(None, T(pts), thr, angular=angular, idx=idx)
    assert int(js) == ts and np.array_equal(np.asarray(jm), tm.numpy())
    for a, b in zip(tp, jp):
        close(a, b)
    assert int(js) >= 72


def test_plane_errors():
    pts = np.random.default_rng(1).normal(size=(5, 3, 3))
    jp, jok = jplane.plane_from_3_points(jnp.asarray(pts))
    tp, tok = tplane.plane_from_3_points(T(pts))
    assert np.array_equal(np.asarray(jok), tok.numpy())
    x = np.random.default_rng(2).normal(size=(5, 3))
    close(tplane.abs_distance(tp, T(x)), jplane.abs_distance(jp, jnp.asarray(x)))
    close(tplane.abs_angular_error(tp, T(x)), jplane.abs_angular_error(jp, jnp.asarray(x)))
    _, bad = tplane.plane_from_3_points(T([[0, 0, 0], [1, 1, 1], [2, 2, 2]]))
    assert not bool(bad)


@pytest.mark.parametrize("pts", [np.zeros((0, 2)), [[1.0, 2.0]], [[0, 0], [1, 1], [2, 2]],
                                 np.random.default_rng(3).normal(size=(50, 2))])
def test_convex_hull(pts):
    h1, h2 = thull.compute_convex_hull(pts), jhull.compute_convex_hull(pts)
    assert np.array_equal(h1, h2)
    assert thull.convex_polygon_area(h1) == jhull.convex_polygon_area(h2)
    for p in np.random.default_rng(4).normal(size=(20, 2)):
        assert thull.is_in(p, h1) == jhull.is_in(p, h2)


def test_frustum_filter_and_corners():
    s = ring_scene(n_views=6, n_points=40, seed=0)
    jsc = scene_from_ring(s, seed=1)
    tsc = from_reference(jsc)
    pairs = [(i, j) for i in range(6) for j in range(i + 1, 6)]
    assert tfr.frustum_filter_pairs(tsc, pairs) == jfr.frustum_filter_pairs(jsc, pairs)
    assert tfr.frustum_filter_pairs(tsc, pairs, 0.1, 2.0) == \
        jfr.frustum_filter_pairs(jsc, pairs, 0.1, 2.0)
    K = s.K[0]
    ca = tfr.frustum_corners(K, s.R[0], s.C[0], 1000, 1000, 0.1, 5.0)
    close(ca, jfr.frustum_corners(K, s.R[0], s.C[0], 1000, 1000, 0.1, 5.0))
    box = tfr.box_corners([-1, -1, -1], [1, 1, 1])
    assert tfr.frusta_intersect(ca, box) == jfr.frusta_intersect(ca, box)


def test_geodesy():
    lla = np.array([[48.8566, 2.3522, 35.0], [-33.8688, 151.2093, 58.0],
                    [64.1466, -21.9426, 0.0]])
    ecef = tgeo.lla_to_ecef(lla[:, 0], lla[:, 1], lla[:, 2])
    close(tgeo.ecef_to_lla(ecef), jgeo.ecef_to_lla(ecef))
    close(tgeo.ecef_to_lla(ecef), lla, 1e-7)
    for lat, lon, alt in lla:
        e1, n1, a1, z1 = tgeo.lla_to_utm(lat, lon, alt)
        e2, n2, a2, z2 = jgeo.lla_to_utm(lat, lon, alt)
        assert z1 == z2 and a1 == a2
        close([e1, n1], [e2, n2])


def test_align_poses_rts():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(12, 3))
    y = 2.5 * x @ np.asarray(jsim.find_rts(jnp.asarray(x), jnp.asarray(rng.normal(size=(12, 3)))).R).T + 1.0
    a = tsim.align_poses_rts(T(x), T(y))
    b = jsim.align_poses_rts(jnp.asarray(x), jnp.asarray(y))
    for u, v in zip(a, b):
        close(u, v)


def _projection(seed):
    s = ring_scene(n_views=3, n_points=30, seed=seed)
    P = s.K[1] @ np.concatenate([s.R[1], s.t[1][:, None]], 1)
    return s, P


def test_dlt6_and_projection_error():
    """On conditioned pixels ((x - 500) / 500, as a DLT caller conditions
    them): both packages take the null vector from eigh of A^T A, and on raw
    pixels (A^T A of norm ~1e7 against an eigenvalue gap of ~1e-2) the two
    LAPACK drivers' rounding differs by ~1e-9 of |P|.  Noisy and weighted."""
    s, _ = _projection(0)
    x = (s.x[1] + np.random.default_rng(6).normal(0, 0.5, s.x[1].shape) - 500.0) / 500.0
    w = np.random.default_rng(7).uniform(0.5, 1.0, len(x))
    for weights in (None, w):
        Pt = tres.solve_dlt6(T(x), T(s.X), None if weights is None else T(weights))
        Pj = jres.solve_dlt6(jnp.asarray(x), jnp.asarray(s.X),
                             None if weights is None else jnp.asarray(weights))
        close(Pt, Pj)
        close(tres.projection_error_sq(T(Pj), T(x), T(s.X)),
              jres.projection_error_sq(Pj, jnp.asarray(x), jnp.asarray(s.X)))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_krt_from_P(sign):
    mats = []
    for seed in range(4):
        _, P = _projection(seed)
        K = np.array([[900.0 + 50 * seed, 2.0, 480], [0, 880.0, 260], [0, 0, 1]])
        P = sign * K @ np.linalg.inv(_projection(seed)[0].K[1]) @ P
        mats.append(P)
    got = tres.krt_from_P(T(np.stack(mats)))       # one batched call
    for i, P in enumerate(mats):
        for a, b in zip(got, jres.krt_from_P(jnp.asarray(P))):
            close(a[i], b)


def test_up2p():
    rng = np.random.default_rng(9)
    S = 16
    ths = rng.uniform(-1, 1, S)
    Rs = np.stack([np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
                   for a in ths])
    X = rng.normal(size=(S, 2, 3)) + np.array([0, 0, 5.0])
    Xc = np.einsum("sij,snj->sni", Rs, X) + rng.normal(size=(S, 3))[:, None]
    b = Xc / np.linalg.norm(Xc, axis=-1, keepdims=True)
    for u, v in zip(tres.solve_up2p(T(b), T(X)), jres.solve_up2p(jnp.asarray(b), jnp.asarray(X))):
        u, v = u.numpy(), np.asarray(v)
        if u.dtype == bool:
            assert np.array_equal(u, v)
        else:
            close(u, v, 1e-8)


def test_preconditioner_from_points():
    rng = np.random.default_rng(10)
    pts = rng.normal(size=(3, 20, 2)) * [300.0, 40.0] + [500, 200]
    pts[2, :, 1] = 7.0     # an axis without variance stays as it is
    mask = rng.random((3, 20)) > 0.3
    close(tcond.preconditioner_from_points(T(pts)),
          jcond.preconditioner_from_points(jnp.asarray(pts)))
    close(tcond.preconditioner_from_points(T(pts), torch.as_tensor(mask)),
          jcond.preconditioner_from_points(jnp.asarray(pts), jnp.asarray(mask)))


def test_sampson_and_symmetric_errors():
    rng = np.random.default_rng(11)
    F = rng.normal(size=(4, 3, 3))
    x1, x2 = rng.uniform(0, 640, (4, 30, 2)), rng.uniform(0, 480, (4, 30, 2))
    close(tfund.sampson_error_sq(T(F), T(x1), T(x2)),
          jfund.sampson_error_sq(jnp.asarray(F), jnp.asarray(x1), jnp.asarray(x2)))
    close(tfund.symmetric_epipolar_error_sq(T(F), T(x1), T(x2)),
          jfund.symmetric_epipolar_error_sq(jnp.asarray(F), jnp.asarray(x1), jnp.asarray(x2)))
