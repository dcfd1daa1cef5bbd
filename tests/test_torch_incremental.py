"""Port parity for the incremental SfM slice: tracks, scene triangulation,
filters, robust resection and relative pose, the whole engine, and the
sfm -> color -> eval CLI, openmvg_torch against openmvg_tpu on the CPU.

Module cases are fed the same numpy inputs (and, for AC-RANSAC, the same
Gumbel draws) and agree to 1e-9 relative in float64, except where a case
says otherwise.  The engine draws from torch.Generators, the reference
from jax.random, so engine cases compare outcomes: poses recovered,
reprojection rmse, trajectory error after 7-DoF alignment.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmvg_tpu.io import sfm_data as jio
from openmvg_tpu.io.gt_loaders import load_strecha_gt as jload_gt
from openmvg_tpu.models import cameras as jcm
from openmvg_tpu.ops import ransac as jransac
from openmvg_tpu.sfm import filters as jfilters
from openmvg_tpu.sfm import robust as jrobust
from openmvg_tpu.sfm.eval_quality import evaluate_against_gt as jevaluate
from openmvg_tpu.sfm.pipeline_incremental import IncrementalConfig as JConfig
from openmvg_tpu.sfm.pipeline_incremental import incremental_sfm as jincremental
from openmvg_tpu.sfm.scene import Scene as JScene
from openmvg_tpu.sfm.scene import rmse as jrmse
from openmvg_tpu.sfm.scene_triangulation import triangulate_tracks as jtriangulate
from openmvg_tpu.sfm.tracks import build_tracks as jbuild_tracks
from openmvg_tpu.utils.synthetic import render_blob_dataset, ring_scene
from openmvg_torch import cli
from openmvg_torch.io import from_reference
from openmvg_torch.io import sfm_data as tio
from openmvg_torch.io.gt_loaders import load_strecha_gt
from openmvg_torch.io.ply import load_ply_vertices
from openmvg_torch.sfm import filters as tfilters
from openmvg_torch.sfm import robust as trobust
from openmvg_torch.sfm.eval_quality import evaluate_against_gt
from openmvg_torch.sfm.pipeline_incremental import IncrementalConfig, incremental_sfm
from openmvg_torch.sfm.scene import rmse
from openmvg_torch.sfm.scene_triangulation import triangulate_tracks
from openmvg_torch.sfm.tracks import build_tracks, tracks_in_views


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs on several workers at once, and
    small tensors gain nothing from more threads than the cores allow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ring_data(s, noise_px=0.0, seed=0):
    """tests/test_incremental.py's scene_and_data: the reference Scene of
    a ring_scene with no poses, features = projections (+ noise), matches
    between each view and its next three on the co-visible points."""
    rng = np.random.default_rng(seed)
    V = s.n_views
    sc = JScene()
    sc.view_filename = [f"v{i}.jpg" for i in range(V)]
    sc.view_intrinsic = np.zeros(V, np.int32)
    sc.view_pose = np.arange(V, dtype=np.int32)
    sc.view_wh = np.tile([[1000, 1000]], (V, 1)).astype(np.int32)
    sc.cameras = jcm.make_pinhole(1000, 1000, s.K[0, 0, 0], s.K[0, 0, 2], s.K[0, 1, 2])
    sc.pose_valid = np.zeros(V, bool)
    sc.pose_R = np.tile(np.eye(3), (V, 1, 1))
    sc.pose_C = np.zeros((V, 3))
    feats = [s.x[v] + (rng.normal(scale=noise_px, size=s.x[v].shape) if noise_px else 0)
             for v in range(V)]
    matches = {}
    for i in range(V):
        for j in range(i + 1, min(i + 4, V)):
            vis = np.nonzero(s.visible[i] & s.visible[j])[0]
            matches[(i, j)] = np.stack([vis, vis], axis=1)
    return sc, feats, matches


def _ate_aligned(C_est, C_gt):
    """7-DoF aligned centres and their RMS distance to the ground truth."""
    from openmvg_torch.geometry.similarity import find_rts

    sim = find_rts(torch.as_tensor(C_est)[None], torch.as_tensor(C_gt)[None])
    al = sim.apply(torch.as_tensor(C_est)[None])[0].numpy()
    return al, float(np.sqrt(np.mean(np.sum((al - C_gt) ** 2, 1))))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_build_tracks_matches_reference():
    """Same tracks as the reference (its native union-find or scipy path),
    including a conflicted track (two features of one view) and a short
    one, which both drop."""
    rng = np.random.default_rng(0)
    matches = {(i, j): np.stack([rng.permutation(60)[:40], rng.permutation(60)[:40]], 1)
               for i in range(5) for j in range(i + 1, 5)}
    matches[(0, 1)] = np.concatenate([matches[(0, 1)], [[59, 0], [58, 0]]])
    t = build_tracks(matches)
    j = jbuild_tracks(matches)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(tracks_in_views(t, [0, 2]),
                                  np.unique(t.track_id[np.isin(t.track_id, t.track_id[
                                      t.view_id == 0]) & (t.view_id == 2)]))


def _posed_ring(seed, noise_px=0.3, kind=jcm.PINHOLE, disto=()):
    s = ring_scene(n_views=6, n_points=80, seed=seed)
    rng = np.random.default_rng(seed + 1)
    sc = JScene()
    V = s.n_views
    sc.view_filename = [f"v{i}.jpg" for i in range(V)]
    sc.view_intrinsic = np.zeros(V, np.int32)
    sc.view_pose = np.arange(V, dtype=np.int32)
    sc.view_wh = np.tile([[1000, 1000]], (V, 1)).astype(np.int32)
    sc.cameras = jcm.make_pinhole(1000, 1000, s.K[0, 0, 0], kind=kind, disto=disto)
    sc.pose_valid = np.ones(V, bool)
    sc.pose_R, sc.pose_C = s.R.copy(), s.C.copy()
    ov, ol = np.nonzero(s.visible)
    x = s.x[ov, ol] + rng.normal(scale=noise_px, size=(len(ov), 2))
    return s, sc, ov.astype(np.int32), ol.astype(np.int32), x


@pytest.mark.parametrize("kind,disto", [(jcm.PINHOLE, ()),
                                        (jcm.PINHOLE_RADIAL_K3, (-0.05, 0.01, 0.001))])
def test_triangulate_tracks_matches_reference(kind, disto):
    s, sc, ov, ol, x = _posed_ring(1, kind=kind, disto=disto)
    x[::17] += 30.0                                 # some fail the residual gate
    Xj, okj = jtriangulate(sc, ov, x, ol, s.n_points)
    Xt, okt = triangulate_tracks(from_reference(sc), ov, x, ol, s.n_points)
    np.testing.assert_array_equal(okt, np.asarray(okj))
    np.testing.assert_allclose(Xt[okt], np.asarray(Xj)[okt], rtol=1e-9, atol=1e-9)
    assert okt.mean() > 0.5


def test_filters_match_reference():
    s, sc, ov, ol, x = _posed_ring(2)
    sc.X = s.X.copy()
    sc.X_valid = np.ones(s.n_points, bool)
    sc.obs_view, sc.obs_landmark, sc.obs_x = ov, ol, x
    sc.obs_feat = ol.copy()
    sc.obs_valid = np.ones(len(ov), bool)
    sc.obs_x[::9] += 25.0
    sc.pose_C[5] = sc.pose_C[4] + 1e-3      # a near-duplicate view: narrow rays
    tsc = from_reference(sc)
    assert (tfilters.bad_track_rejector(tsc, 4.0, 5)
            == jfilters.bad_track_rejector(sc, 4.0, 5))
    np.testing.assert_array_equal(tsc.obs_valid, sc.obs_valid)
    np.testing.assert_array_equal(tsc.X_valid, sc.X_valid)
    sc.obs_valid[sc.obs_view == 3] = False
    tsc.obs_valid[tsc.obs_view == 3] = False
    assert (tfilters.erase_unstable_poses_and_observations(tsc, 6)
            == jfilters.erase_unstable_poses_and_observations(sc, 6))
    np.testing.assert_array_equal(tsc.pose_valid, sc.pose_valid)
    np.testing.assert_array_equal(tsc.obs_valid, sc.obs_valid)
    assert abs(rmse(tsc) - jrmse(sc)) < 1e-9


def _with_table(monkeypatch, table, s1):
    """The reference's draw_samples fed rows of one Gumbel table."""
    calls = []

    def draw(key, n, sample_size, weights):
        rows = table[:s1] if not calls else table[s1:]
        calls.append(n)
        logw = jnp.where(weights > 0, jnp.log(jnp.maximum(weights, 1e-30)), -jnp.inf)
        return jax.lax.top_k(jnp.asarray(rows) + logw[None, :], sample_size)[1]

    monkeypatch.setattr(jransac, "draw_samples", draw)
    return calls


def test_resection_p3p_same_draws_same_result(monkeypatch):
    s, sc, ov, ol, x = _posed_ring(3, noise_px=0.5)
    v = 2
    sel = ov == v
    X = s.X[ol[sel]]
    xy = x[sel]
    xy[::7] += 40.0
    K = s.K[v]
    b = np.c_[(xy - K[:2, 2]) / K[0, 0], np.ones(len(xy))]
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    n_samples = 128
    table = np.random.default_rng(4).gumbel(size=(n_samples, len(xy)))
    _with_table(monkeypatch, table, n_samples * 9 // 10)
    ref = jax.jit(jrobust.robust_resection_p3p.__wrapped__, static_argnames="n_samples")(
        jax.random.PRNGKey(0), jnp.asarray(b), jnp.asarray(xy), jnp.asarray(X),
        jnp.asarray(K), jnp.ones(len(xy), bool), 1000.0, 1000.0, n_samples=n_samples)
    got = trobust.robust_resection_p3p(
        None, torch.as_tensor(b), torch.as_tensor(xy), torch.as_tensor(X), torch.as_tensor(K),
        torch.ones(len(xy), dtype=torch.bool), 1000.0, 1000.0, n_samples=n_samples,
        gumbel=torch.as_tensor(table))
    assert bool(got.found) == bool(ref.found)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(float(got.nfa), float(ref.nfa), rtol=1e-9)
    for a, r in zip(got.model, ref.model):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-7, atol=1e-9)
    # the port's pose refine moves the pose to the noise floor
    rv, tv = trobust.refine_poses_batch(
        torch.as_tensor(__import__("openmvg_torch.utils.hostmath", fromlist=["x"])
                        .logmap_np(got.model[0].numpy()))[None], got.model[1][None],
        torch.tensor([jcm.PINHOLE]), torch.as_tensor(sc.cameras.params)[:1].double(),
        torch.tensor([[1000.0, 1000.0]], dtype=torch.float64), torch.as_tensor(X)[None],
        torch.as_tensor(xy)[None], got.inliers[None].double())
    assert torch.isfinite(rv).all() and torch.isfinite(tv).all()


def test_relative_pose_same_draws_same_outcome(monkeypatch):
    """The 5-point solvers return the same solution sets in another order
    (ops/essential.py), so with one Gumbel table both pick the true
    motion: same inliers, R and t to 1e-6."""
    s, sc, ov, ol, x = _posed_ring(5, noise_px=0.3)
    va, vb = 0, 1
    common = np.intersect1d(ol[ov == va], ol[ov == vb])
    xa = s.x[va, common] + np.random.default_rng(6).normal(scale=0.3, size=(len(common), 2))
    xb = s.x[vb, common] + np.random.default_rng(7).normal(scale=0.3, size=(len(common), 2))
    xb[::11] += 30.0
    K = s.K[0]

    def bear(p):
        b = np.c_[(p - K[:2, 2]) / K[0, 0], np.ones(len(p))]
        return b / np.linalg.norm(b, axis=1, keepdims=True)

    n_samples = 128
    table = np.random.default_rng(8).gumbel(size=(n_samples, len(common)))
    _with_table(monkeypatch, table, n_samples * 9 // 10)
    args = (bear(xa), bear(xb), xa, xb, K, K)
    ref = jax.jit(jrobust.robust_relative_pose.__wrapped__,
                  static_argnames=("n_samples", "angular"))(
        jax.random.PRNGKey(0), *map(jnp.asarray, args), jnp.ones(len(xa), bool),
        1000.0, 1000.0, n_samples=n_samples)
    got = trobust.robust_relative_pose(
        None, *map(torch.as_tensor, args), torch.ones(len(xa), dtype=torch.bool),
        1000.0, 1000.0, n_samples=n_samples, gumbel=torch.as_tensor(table))
    assert bool(got.found) and bool(ref.found)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-6)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-6)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

CFG = dict(ransac_samples=512, resection_samples=512, init_pair_samples=512,
           min_init_inliers=40, ba_iterations=15)


def test_incremental_both_engines_on_ring_scene(tmp_path):
    """tests/test_incremental.py::test_incremental_pipeline_exact through
    both engines: all 8 poses, rmse < 0.3 px, ATE < 0.02 for each, and
    their aligned camera centres within 1e-3 of each other.  The
    reference's scene, saved by the reference, is read back and evaluated
    by the port."""
    s = ring_scene(n_views=8, n_points=120, seed=0)
    jsc, feats, matches = ring_data(s)
    tsc = from_reference(jsc)
    jincremental(jsc, feats, matches, JConfig(**CFG), seed=0)
    incremental_sfm(tsc, feats, matches, IncrementalConfig(**CFG), seed=0, device="cpu")
    aligned = []
    for sc in (jsc, tsc):
        assert int(sc.pose_valid.sum()) == s.n_views
        assert sc.n_landmarks > 100
        al, ate = _ate_aligned(sc.pose_C, s.C)
        assert ate < 0.02
        aligned.append(al)
    assert rmse(tsc) < 0.3 and jrmse(jsc) < 0.3
    np.testing.assert_allclose(aligned[1], aligned[0], atol=1e-3)

    path = str(tmp_path / "ref_sfm_data.json")
    jio.save_sfm_data(jsc, path)
    back = tio.load_sfm_data(path)
    np.testing.assert_allclose(back.pose_C[back.pose_valid], jsc.pose_C[jsc.pose_valid],
                               atol=1e-12)
    gt = from_reference(jsc)
    gt.pose_C, gt.pose_R, gt.pose_valid = s.C.copy(), s.R.copy(), np.ones(8, bool)
    st = evaluate_against_gt(back, gt)
    assert st["ok"] and st["n_common"] == 8 and st["position_rmse"] < 0.02


def test_incremental_same_seed_same_scene():
    s = ring_scene(n_views=6, n_points=80, seed=3)
    out = []
    for _ in range(2):
        jsc, feats, matches = ring_data(s, noise_px=0.3, seed=4)
        sc = from_reference(jsc)
        incremental_sfm(sc, feats, matches, IncrementalConfig(**CFG), seed=7, device="cpu")
        out.append(sc)
    a, b = out
    assert int(a.pose_valid.sum()) == s.n_views
    for f in ("pose_valid", "pose_R", "pose_C", "X", "X_valid", "obs_valid", "obs_landmark"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.cameras.params, b.cameras.params)


def test_incremental_rejects_unported_engine_version():
    """engine_version 2 (INCREMENTALV2) is ported: its candidate rule,
    _find_v2_group, picks the reference's views in the reference's order
    for each ratio of the schedule, with posed views and views that failed
    three rounds left out."""
    from openmvg_tpu.sfm.pipeline_incremental import _TrackIndex as JIndex
    from openmvg_tpu.sfm.pipeline_incremental import _find_v2_group as jfind
    from openmvg_torch.sfm.pipeline_incremental import _TrackIndex, _find_v2_group

    s = ring_scene(n_views=12, n_points=150, seed=4)
    jsc, feats, matches = ring_data(s)
    tracks = build_tracks(matches)
    rng = np.random.default_rng(5)
    lot = np.where(rng.random(tracks.n_tracks) < 0.35, np.arange(tracks.n_tracks), -1)
    posed, failed = {0, 1, 2}, {7: 3, 8: 1}
    tindex = _TrackIndex(tracks, feats)
    jindex = JIndex(jbuild_tracks(matches), feats)
    for ratio in (0.2, 0.1, 0.0):
        got = _find_v2_group(from_reference(jsc), tindex, posed, lot, ratio, failed)
        assert got == jfind(jsc, jindex, posed, lot, ratio, failed)
        assert not set(got) & (posed | {7})
    assert IncrementalConfig().v2_track_inlier_ratios == JConfig().v2_track_inlier_ratios


def test_cli_sfm_color_eval_on_rendered_views(tmp_path, capsys):
    """The port's CLI from images to eval on render_scene (5 views, 256^2,
    focal 320, as the verify skill drives it), intrinsics held: all views
    posed, rmse < 1 px, position rmse under 2% of the 3.0 arc radius.  The
    reference's eval reads the port's sfm_data.json and agrees with the
    port's to 1e-9; colorized.ply holds one colour per landmark."""
    tmp = str(tmp_path)
    imgdir, gtdir, Rs, Cs, K = render_blob_dataset(tmp, n_views=5, n_points=300,
                                                   size=256, focal=320.0)
    out, md, recon = (os.path.join(tmp, d) for d in ("out", "matches", "recon"))
    sfm = os.path.join(out, "sfm_data.json")
    dev = ["--device", "cpu"]
    for argv in (["init", "-i", imgdir, "-o", out, "-f", "320", "-c", "1"],
                 ["features", "-i", sfm, "-o", md, "-p", "HIGH"],
                 ["pairs", "-i", sfm, "-o", os.path.join(md, "pairs.txt")],
                 ["matches", "-i", sfm, "-o", os.path.join(md, "matches.putative.bin"),
                  "-p", os.path.join(md, "pairs.txt"), "-r", "0.9"],
                 ["filter", "-i", sfm, "-m", os.path.join(md, "matches.putative.bin"),
                  "-o", os.path.join(md, "matches.f.bin")],
                 ["sfm", "-i", sfm, "-m", md, "-o", recon, "-f", "ADJUST_NONE"],
                 ["color", "-i", os.path.join(recon, "sfm_data.json"),
                  "-o", os.path.join(recon, "colorized.ply")]):
        assert cli.main(argv + dev) == 0, argv[0]
    printed = capsys.readouterr().out
    assert "bundle_adjustment" in printed and "f64 polish steps" in printed

    est = tio.load_sfm_data(os.path.join(recon, "sfm_data.json"))
    assert int(est.pose_valid.sum()) == 5
    assert rmse(est) < 1.0
    st = evaluate_against_gt(est, load_strecha_gt(gtdir))
    assert st["ok"] and st["position_rmse"] < 0.06
    ref = jevaluate(jio.load_sfm_data(os.path.join(recon, "sfm_data.json")), jload_gt(gtdir))
    for k in ("n_common", "position_rmse", "rotation_error_mean_deg", "scale"):
        assert abs(st[k] - ref[k]) <= 1e-9 * (1 + abs(ref[k])), k
    pts, cols = load_ply_vertices(os.path.join(recon, "colorized.ply"))
    assert len(pts) == est.n_landmarks + 5
    assert cols[:est.n_landmarks].any()
    assert cli.main(["eval", "-i", os.path.join(recon, "sfm_data.json"), "-g", gtdir]
                    + dev) == 0
