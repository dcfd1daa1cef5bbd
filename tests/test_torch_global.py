"""Port parity for the components of the global SfM slice: the view-graph
helpers, rotation averaging, translation averaging, triplet translations
and the essential-matrix filter, openmvg_torch against openmvg_tpu on the
same numpy inputs, float64 on the CPU.

The graph helpers agree exactly (the engine's greedy edge coverage reads
triplets in their order).  The averaging solvers assemble the same normal
equations (in another order of additions) and solve them with other
dense factorizations, so they agree to 1e-8 after the same gauge (view 0).
AC-RANSAC cases feed both packages one Gumbel table (the reference's
draw_samples monkeypatched) and agree on the found flag and the inlier set,
the model to 1e-8.  The engine and the CLI are in
tests/test_torch_global_engine.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmvg_tpu.geometry import so3 as jso3
from openmvg_tpu.ops import rotation_averaging as jra
from openmvg_tpu.ops import translation_averaging as jta
from openmvg_tpu.ops import triplet_translation as jtt
from openmvg_tpu.sfm import geometric_filter as jgf
from openmvg_tpu.sfm import robust as jrobust
from openmvg_tpu.utils import graph as jgraph
from openmvg_tpu.utils.synthetic import ring_scene
from openmvg_torch.io import from_reference
from openmvg_torch.ops import rotation_averaging as tra
from openmvg_torch.ops import translation_averaging as tta
from openmvg_torch.ops import triplet_translation as ttt
from openmvg_torch.ops.l1_admm import solve_lad
from openmvg_torch.sfm import geometric_filter as tgf
from openmvg_torch.sfm import robust as trobust
from openmvg_torch.utils import graph as tgraph
from tests.test_averaging import make_rel
from tests.test_torch_incremental import _with_table, ring_data
from tests.test_triplet_translation import _triplet_scene


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs on several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(seed):
    """A random view graph with dangling chains (bridges) and a second
    component."""
    rng = np.random.default_rng(seed)
    pairs = {(int(i), int(j)) for i, j in rng.integers(0, 14, (40, 2)) if i != j}
    pairs |= {(14, 15), (15, 16), (20, 21), (21, 22), (20, 22), (3, 30)}
    return sorted(pairs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_graph_helpers_match_reference_exactly(seed):
    pairs = _graph(seed)
    np.testing.assert_array_equal(tgraph.pairs_to_edges(pairs), jgraph.pairs_to_edges(pairs))
    assert tgraph.connected_components(pairs) == jgraph.connected_components(pairs)
    adj_t, adj_j = tgraph._adjacency(tgraph.pairs_to_edges(pairs)), {}
    for i, j in jgraph.pairs_to_edges(pairs):
        adj_j.setdefault(int(i), set()).add(int(j))
        adj_j.setdefault(int(j), set()).add(int(i))
    assert tgraph._bridges(adj_t) == jgraph._bridges(adj_j)
    assert (tgraph.largest_biedge_connected_component(pairs)
            == jgraph.largest_biedge_connected_component(pairs))
    assert tgraph.list_triplets(pairs) == jgraph.list_triplets(pairs)   # order included


def _rot(R):
    return np.asarray(R) if not torch.is_tensor(R) else R.numpy()


@pytest.mark.parametrize("noise,outliers,weighted", [(0.0, 0, False), (0.02, 0, True),
                                                     (0.01, 3, True)])
def test_l2_rotation_averaging_matches_reference(noise, outliers, weighted):
    s, ei, ej, R = make_rel(noise=noise, seed=3, outliers=outliers)
    w = np.random.default_rng(0).uniform(0.2, 1.0, len(ei)) if weighted else None
    ref = jra.l2_rotation_averaging(s.n_views, jnp.asarray(ei), jnp.asarray(ej),
                                    jnp.asarray(R), None if w is None else jnp.asarray(w))
    got = tra.l2_rotation_averaging(s.n_views, ei, ej, R, w)
    np.testing.assert_allclose(_rot(got), _rot(ref), atol=1e-8)


@pytest.mark.parametrize("solver,n_irls", [("irls", 16), ("admm", 3)])
def test_l1_rotation_averaging_matches_reference(solver, n_irls):
    s, ei, ej, R = make_rel(noise=0.01, seed=4, outliers=3)
    w = np.random.default_rng(1).uniform(0.5, 1.0, len(ei))
    ref = jra.l1_rotation_averaging(s.n_views, ei, ej, jnp.asarray(R), jnp.asarray(w),
                                    n_irls=n_irls, solver=solver)
    got = tra.l1_rotation_averaging(s.n_views, ei, ej, R, w, n_irls=n_irls, solver=solver)
    np.testing.assert_allclose(_rot(got), _rot(ref), atol=1e-8)


def test_spanning_tree_and_triplet_rejection_match_reference():
    s, ei, ej, R = make_rel(noise=0.01, seed=6)
    w = np.random.default_rng(2).uniform(0.5, 1.0, len(ei))
    np.testing.assert_allclose(tra.spanning_tree_rotations(s.n_views, ei, ej, R, w),
                               jra.spanning_tree_rotations(s.n_views, ei, ej, R, w), atol=1e-12)
    pairs = list(zip(ei.tolist(), ej.tolist()))
    rel = {p: R[k] for k, p in enumerate(pairs)}
    rel[pairs[1]] = np.asarray(jso3.expmap(jnp.asarray([1.0, 0.5, 0.2])))
    kept_t, tri_t = tra.triplet_rotation_rejection(pairs, rel, 3.0)
    kept_j, tri_j = jra.triplet_rotation_rejection(pairs, rel, 3.0)
    assert tri_t == tri_j and kept_t == kept_j and list(kept_t) == list(kept_j)
    assert pairs[1] not in kept_t


def test_lad_admm_matches_reference():
    from openmvg_tpu.ops.l1_admm import solve_lad as jsolve_lad

    rng = np.random.default_rng(0)
    A = np.stack([rng.uniform(-1, 1, 200), np.ones(200)], 1)
    b = A @ np.array([2.0, -0.5]) + rng.normal(0, 0.01, 200)
    b[rng.choice(200, 60, replace=False)] += 5.0
    ref = np.asarray(jsolve_lad(jnp.asarray(A), jnp.asarray(b), iters=400))
    got = solve_lad(torch.as_tensor(A), torch.as_tensor(b), iters=400).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-8)
    assert np.linalg.norm(got - [2.0, -0.5]) < 0.02


@pytest.mark.parametrize("method", [tta.SOFTL1, tta.L2, tta.L1])
@pytest.mark.parametrize("grouped", [False, True])
def test_translation_averaging_matches_reference(method, grouped):
    """Noisy unit relative translations; with groups, every three edges
    share one scale."""
    s, ei, ej, R = make_rel(n=10, seed=5)
    t_gt = np.asarray([-Ri @ C for Ri, C in zip(s.R, s.C)])
    t_rel = t_gt[ej] - np.einsum("eij,ej->ei", R, t_gt[ei])
    t_rel /= np.linalg.norm(t_rel, axis=1, keepdims=True)
    t_rel += np.random.default_rng(0).normal(scale=0.01, size=t_rel.shape)
    sg = np.arange(len(ei)) // 3 if grouped else None
    t_j, s_j = jta.solve_translation_averaging(s.n_views, ei, ej, R, t_rel, method=method,
                                               scale_group=sg)
    t_t, s_t = tta.solve_translation_averaging(s.n_views, ei, ej, R, t_rel, method=method,
                                               scale_group=sg)
    np.testing.assert_allclose(t_t, t_j, atol=1e-8)
    np.testing.assert_allclose(s_t, s_j, atol=1e-8)


def test_translations_known_rotations_match_reference():
    Rs, ts_gt, xs = _triplet_scene(n_tracks=50)
    valid = np.ones(50)
    valid[40:] = 0.0
    xs = xs.copy()
    xs[:, 40:] = 7.7                       # masked tracks must not matter
    for sub, v in ((xs[:, :4], None), (xs, valid)):
        ts_j, X_j = jtt.solve_translations_known_rotations(
            jnp.asarray(sub), jnp.asarray(Rs), None if v is None else jnp.asarray(v))
        ts_t, X_t = ttt.solve_translations_known_rotations(
            torch.as_tensor(sub), torch.as_tensor(Rs), None if v is None else torch.as_tensor(v))
        np.testing.assert_allclose(ts_t.numpy(), np.asarray(ts_j), atol=1e-9)
        keep = slice(None) if v is None else slice(0, 40)
        np.testing.assert_allclose(X_t.numpy()[keep], np.asarray(X_j)[keep], atol=1e-8)
    # batched over (triplets, samples): each entry solves alone
    batch = np.stack([xs[:, :4], xs[:, 4:8], xs[:, 8:12]])[:, None]
    ts_b, _ = ttt.solve_translations_known_rotations(torch.as_tensor(batch),
                                                     torch.as_tensor(Rs)[None, None])
    for k in range(3):
        one, _ = ttt.solve_translations_known_rotations(torch.as_tensor(batch[k, 0]),
                                                        torch.as_tensor(Rs))
        np.testing.assert_allclose(ts_b[k, 0].numpy(), one.numpy(), atol=1e-12)


def test_max_reproj_error_matches_reference():
    Rs, ts_gt, xs = _triplet_scene(n_tracks=40)
    rng = np.random.default_rng(3)
    xs = xs + rng.normal(scale=1e-3, size=xs.shape)
    xs[:, 5] = [[0.3, 0.1], [-2.0, 0.4], [0.0, 9.0]]          # a gross outlier
    ts = ts_gt + rng.normal(scale=1e-3, size=ts_gt.shape)
    ref = np.asarray(jtt._max_reproj_error(jnp.asarray(ts), jnp.asarray(Rs), jnp.asarray(xs)))
    got = ttt._max_reproj_error(torch.as_tensor(ts), torch.as_tensor(Rs),
                                torch.as_tensor(xs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize("kind", ["outliers", "garbage"])
def test_triplet_acransac_same_draws_same_result(kind, monkeypatch):
    Rs, ts_gt, xs = _triplet_scene()
    rng = np.random.default_rng(1)
    if kind == "outliers":
        xs = xs + rng.normal(size=xs.shape) * 5e-4
        out = rng.random(xs.shape[1]) < 0.3
        xs[:, out] = rng.normal(size=xs[:, out].shape) * 0.3
        prec = 0.01
    else:
        xs = rng.normal(size=(3, 40, 2)) * 0.3
        prec = 0.005
    n = xs.shape[1]
    n_samples = 128
    table = np.random.default_rng(7).gumbel(size=(n_samples, n))
    _with_table(monkeypatch, table, n_samples * 9 // 10)
    ref = jax.jit(jtt.triplet_translation_acransac, static_argnames="n_samples")(
        jax.random.PRNGKey(0), jnp.asarray(xs), jnp.asarray(Rs), jnp.ones(n, bool),
        n_samples=n_samples, precision_norm=prec)
    got = ttt.triplet_translation_acransac(None, torch.as_tensor(xs), torch.as_tensor(Rs),
                                           torch.ones(n, dtype=torch.bool), n_samples=n_samples,
                                           precision_norm=prec, gumbel=torch.as_tensor(table))
    assert bool(got.found) == bool(ref.found) == (kind == "outliers")
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    if kind == "outliers":
        np.testing.assert_allclose(got.ts.numpy(), np.asarray(ref.ts), atol=1e-8)
        np.testing.assert_allclose(float(got.nfa), float(ref.nfa), rtol=1e-9)
        np.testing.assert_allclose(float(got.threshold_sq), float(ref.threshold_sq), rtol=1e-9)


def _essential_pair(seed):
    """Two ring views with half a pixel of noise and 30% gross outliers:
    bearings, pixels and K of their shared points."""
    s = ring_scene(n_views=2, n_points=200, seed=seed)
    vis = np.nonzero(s.visible[0] & s.visible[1])[0]
    rng = np.random.default_rng(seed + 1)
    xa = s.x[0][vis] + rng.normal(scale=0.5, size=(len(vis), 2))
    xb = s.x[1][vis] + rng.normal(scale=0.5, size=(len(vis), 2))
    xb[: len(vis) * 3 // 10] = rng.uniform(0, 1000, (len(vis) * 3 // 10, 2))
    K = s.K[0]

    def bear(p):
        b = np.c_[(p - K[:2, 2]) / K[0, 0], np.ones(len(p))]
        return b / np.linalg.norm(b, axis=1, keepdims=True)

    return bear(xa), bear(xb), xa, xb, K


def test_robust_essential_same_draws_same_result(monkeypatch):
    """The filter's -g e kernel: 5-point AC-RANSAC with the pixel
    point-to-line residual through K, one Gumbel table for both."""
    ba_, bb_, xa, xb, K = _essential_pair(2)
    n_samples = 128
    table = np.random.default_rng(9).gumbel(size=(n_samples, len(xa)))
    _with_table(monkeypatch, table, n_samples * 9 // 10)
    args = (ba_, bb_, xa, xb, K, K)
    ref = jax.jit(jrobust.robust_essential.__wrapped__, static_argnames="n_samples")(
        jax.random.PRNGKey(0), *map(jnp.asarray, args), jnp.ones(len(xa), bool), 1000.0,
        1000.0, n_samples=n_samples, precision_sq=16.0)
    got = trobust.robust_essential(None, *map(torch.as_tensor, args),
                                   torch.ones(len(xa), dtype=torch.bool), 1000.0, 1000.0,
                                   n_samples=n_samples, precision_sq=16.0,
                                   gumbel=torch.as_tensor(table))
    assert bool(got.found) and bool(ref.found)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(float(got.nfa), float(ref.nfa), rtol=1e-9)
    np.testing.assert_allclose(float(got.threshold_sq), float(ref.threshold_sq), rtol=1e-9)


def test_filter_e_keeps_the_reference_pairs():
    """geometric_filter(model="e") on the 6-view ring with 20% gross
    outliers in every pair, each package with its own random streams: the
    same pairs are kept, each keeps at most 10% of the outliers (one that
    lands near its epipolar line passes any epipolar test), and the kept sets
    agree on at least 95% of the matches (each threshold follows its own
    model).  Model h, which raised before it was ported, now runs: the
    ring is no plane, so it keeps fewer matches than e."""
    s = ring_scene(n_views=6, n_points=150, seed=1)
    jsc, feats, matches = ring_data(s, noise_px=0.3, seed=2)
    rng = np.random.default_rng(3)
    feats = [f.copy() for f in feats]
    bad = {}
    for (i, j), m in matches.items():
        k = rng.choice(len(m), len(m) // 5, replace=False)
        m[k, 1] = rng.permutation(m[k, 1])
        bad[(i, j)] = {tuple(r) for r in m[k] if r[0] != r[1]}
    ref = jgf.geometric_filter(jsc, feats, matches, model="e", n_samples=256)
    got = tgf.geometric_filter(from_reference(jsc), feats, matches, model="e", n_samples=256,
                               device="cpu")
    assert sorted(got) == sorted(ref) and len(got) == len(matches)
    for p in got:
        a = {tuple(r) for r in got[p]}
        b = {tuple(r) for r in np.asarray(ref[p])}
        assert len(a & bad[p]) <= 0.1 * len(bad[p]) and len(b & bad[p]) <= 0.1 * len(bad[p])
        assert len(a & b) >= 0.95 * max(len(a), len(b))
    got_h = tgf.geometric_filter(from_reference(jsc), feats, matches, model="h", n_samples=256,
                                 device="cpu")
    assert all(len(got_h[p]) < len(got[p]) for p in got_h)
