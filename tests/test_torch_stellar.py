"""The port's STELLAR engine on the CPU: its components against the
reference's (graph simplification, the 2-view depth maps, the L1 pod scale
solve, translation averaging with one scale per pod), the four cases of
tests/test_stellar.py run on the port, and the fused S-matvec (K3's plain
version on the CPU) leaving the result unchanged.

The reference's whole-engine runs take minutes on the CPU (its own
tests/test_stellar.py is marked slow), so the engine is held to the
reference's test gates and the components to the reference itself.
"""

import numpy as np
import pytest
import torch

from openmvg_tpu.ops import translation_averaging as jta
from openmvg_tpu.sfm import pipeline_stellar as JS
from openmvg_tpu.sfm.pipeline_incremental import _TrackIndex as JIndex
from openmvg_tpu.sfm.tracks import build_tracks as jbuild_tracks
from openmvg_tpu.utils.synthetic import ring_scene
from openmvg_torch.io import from_reference
from openmvg_torch.ops import translation_averaging as tta
from openmvg_torch.sfm import pipeline_stellar as S
from openmvg_torch.sfm.pipeline_global import compute_relative_poses
from openmvg_torch.sfm.pipeline_incremental import _TrackIndex
from openmvg_torch.sfm.scene import rmse
from openmvg_torch.sfm.tracks import build_tracks
from tests.test_torch_incremental import _ate_aligned, ring_data
from tests.test_torch_smatvec import k3_on_the_cpu


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs on several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_matches(n_views=12, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n_views):
        for j in range(i + 1, n_views):
            if j - i <= 3 or rng.random() < 0.2:
                out[(i, j)] = np.zeros((int(rng.integers(20, 400)), 2), np.int64)
    return out


@pytest.mark.parametrize("method,value", [("MST_X", 5), ("MST_X", 1), ("STAR_X", 4),
                                          ("STAR_X", 2), ("NONE", 5)])
def test_graph_simplification_selects_the_reference_pairs(method, value):
    m = _random_matches()
    cfg = dict(graph_simplification=method, graph_simplification_value=value)
    got = S._simplify_graph(m, S.StellarConfig(**cfg))
    assert got == JS._simplify_graph(m, JS.StellarConfig(**cfg))
    assert S._mst_pairs(m, value) == JS._mst_pairs(m, value)
    assert 0 < len(got) <= len(m)


def test_pod_scale_solver_recovers_ratios():
    """tests/test_stellar.py::test_pod_scale_solver_recovers_ratios on the
    port: the L1 log-scale solve reproduces known per-edge scales from
    noisy 2-uplet depth ratios (5%), and agrees with the reference's
    solve within 1e-6."""
    rng = np.random.default_rng(0)
    edges = [(0, 1), (0, 2), (0, 3), (0, 4)]
    true = {e: float(v) for e, v in zip(edges, [1.0, 0.5, 2.0, 0.25])}
    base = {t: rng.uniform(1, 5) for t in range(40)}
    depth_maps = {}
    for e in edges:
        noise = rng.normal(1.0, 0.01, size=40)
        depth_maps[e] = {t: base[t] * true[e] * noise[t] for t in base}
    got = S._pod_scales_l1(depth_maps, edges, S.StellarConfig())
    f = true[(0, 3)] / got[(0, 3)]
    for e in edges:
        assert abs(got[e] * f - true[e]) / true[e] < 0.05, (e, got)
    ref = JS._pod_scales_l1(depth_maps, edges, JS.StellarConfig())
    assert got.keys() == ref.keys()
    for e in edges:
        assert abs(got[e] - ref[e]) <= 1e-6, e


def test_depth_maps_match_reference():
    """The 2-view depth maps of a pod's edges, measured from either end:
    the same tracks, distances within 1e-9 relative."""
    s = ring_scene(n_views=8, n_points=120, seed=0)
    jsc, feats, matches = ring_data(s)
    tindex = _TrackIndex(build_tracks(matches), feats)
    jindex = JIndex(jbuild_tracks(matches), feats)
    sc = from_reference(jsc)
    rel = compute_relative_poses(sc, tindex, [(0, 1), (1, 2), (0, 3)],
                                 S.StellarConfig(ransac_samples=256), 0, "cpu")
    pts = S._pair_points(sc, tindex, rel, "cpu")
    for pair in rel:
        for center in pair:
            got = S._edge_depth_map(pts, rel, pair, center)
            want = JS._edge_depth_map(jsc, jindex, rel, pair, center)
            assert got.keys() == want.keys() and len(got) > 20
            for t in got:
                assert abs(got[t] - want[t]) <= 1e-9 * want[t]


def test_translation_averaging_one_scale_per_pod():
    """SoftL1 with pod scale groups (each edge in two pods, groups of
    uneven size) agrees with the reference within 1e-8."""
    s = ring_scene(n_views=8, n_points=20, seed=2)
    rng = np.random.default_rng(3)
    t_gt = np.asarray([-Ri @ C for Ri, C in zip(s.R, s.C)])
    ei, ej, group = [], [], []
    for g, c in enumerate(range(8)):
        for d in (1, 2, 3)[:1 + g % 3]:
            ei.append(c)
            ej.append((c + d) % 8)
            group.append(g)
    ei, ej = np.asarray(ei), np.asarray(ej)
    R = np.einsum("eij,ekj->eik", s.R[ej], s.R[ei])
    t_rel = t_gt[ej] - np.einsum("eij,ej->ei", R, t_gt[ei])
    t_rel *= rng.uniform(0.5, 2.0, len(ei))[:, None]
    t_rel += rng.normal(scale=0.01, size=t_rel.shape)
    group = np.unique(np.asarray(group), return_inverse=True)[1]
    t_t, s_t = tta.solve_translation_averaging(8, ei, ej, R, t_rel, method=tta.SOFTL1,
                                               scale_group=group)
    t_j, s_j = jta.solve_translation_averaging(8, ei, ej, R, t_rel, method=jta.SOFTL1,
                                               scale_group=group)
    np.testing.assert_allclose(t_t, np.asarray(t_j), atol=1e-8)
    np.testing.assert_allclose(s_t, np.asarray(s_j), atol=1e-8)


def _run(seed, noise_px=0.0, data_seed=0, n_points=120, **kw):
    s = ring_scene(n_views=8, n_points=n_points, seed=seed)
    jsc, feats, matches = ring_data(s, noise_px=noise_px, seed=data_seed)
    sc = from_reference(jsc)
    stats = {}
    S.stellar_sfm(sc, feats, matches, S.StellarConfig(ransac_samples=512, ba_iterations=15, **kw),
                  seed=0, device="cpu", stats=stats)
    return s, sc, stats


def test_stellar_sfm():
    """tests/test_stellar.py::test_stellar_sfm on the port: 8/8 poses,
    more than 80 landmarks, rmse < 0.3 px, ATE < 0.02; one pod a pose and
    no f64 polish."""
    s, sc, stats = _run(0)
    assert int(sc.pose_valid.sum()) == s.n_views
    assert sc.n_landmarks > 80
    assert rmse(sc) < 0.3
    assert _ate_aligned(sc.pose_C, s.C)[1] < 0.02
    assert stats["pods"] == 8 and stats["polish_steps"] == 0 and stats["rounds"] >= 1


def test_stellar_sfm_star_simplification():
    s, sc, _ = _run(1, graph_simplification="STAR_X", graph_simplification_value=4)
    assert int(sc.pose_valid.sum()) == s.n_views
    assert rmse(sc) < 0.3


def test_stellar_sfm_noisy():
    s, sc, _ = _run(2, noise_px=0.4, data_seed=5, n_points=150)
    assert int(sc.pose_valid.sum()) == s.n_views
    assert rmse(sc) < 0.7


def test_stellar_fused_smatvec_same_result(monkeypatch):
    """With K3's plan put on each BA's problem, every BA's CG matvec goes
    through K3 (its plain version on the CPU): poses and points within
    1e-6 of the run without it."""
    _, a, _ = _run(2, noise_px=0.4, data_seed=5, n_points=150)
    k3_on_the_cpu(monkeypatch)
    _, b, _ = _run(2, noise_px=0.4, data_seed=5, n_points=150)
    np.testing.assert_array_equal(a.pose_valid, b.pose_valid)
    np.testing.assert_array_equal(a.X_valid, b.X_valid)
    np.testing.assert_allclose(b.pose_C, a.pose_C, atol=1e-6)
    np.testing.assert_allclose(b.pose_R, a.pose_R, atol=1e-6)
    np.testing.assert_allclose(b.X[b.X_valid], a.X[a.X_valid], atol=1e-6)
