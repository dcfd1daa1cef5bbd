"""Port parity for the spherical path, openmvg_torch against openmvg_tpu
on the same numpy inputs, on the CPU: the equirectangular resamplers
(float32, within 1e-4 of the panorama's range), `cubify` through both
CLIs (faces within 1 gray level: the uint8 truncation of values that
agree to 1e-4 can differ by one), the angular P3P resection on one Gumbel
table (the same inliers, R and t to 1e-6), the port's copy of the
reference test's scene, and INCREMENTAL and GLOBAL on that 6-view scene
(tests/test_spherical_sfm.py) through from_reference: every pose, and the
positions after 7-DoF alignment to the ground truth within 1e-3 of the
reference's own run's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmvg_tpu import cli as jcli
from openmvg_tpu.geometry.similarity import find_rts
from openmvg_tpu.ops import spherical as jsph
from openmvg_tpu.sfm import pipeline_global as jG
from openmvg_tpu.sfm import robust as jrobust
from openmvg_tpu.sfm.pipeline_incremental import IncrementalConfig as JIncConfig
from openmvg_tpu.sfm.pipeline_incremental import incremental_sfm as jincremental
from openmvg_torch import cli as tcli
from openmvg_torch.io import from_reference
from openmvg_torch.io.image import read_image, write_image
from openmvg_torch.io.sfm_data import save_sfm_data
from openmvg_torch.ops import spherical as tsph
from openmvg_torch.sfm import pipeline_global as tG
from openmvg_torch.sfm import robust as trobust
from openmvg_torch.sfm.pipeline_incremental import IncrementalConfig as TIncConfig
from openmvg_torch.sfm.pipeline_incremental import incremental_sfm as tincremental
from openmvg_torch.utils.hostmath import expmap_np
from openmvg_torch.utils.synthetic import spherical_ring_scene
from tests.test_spherical_sfm import _spherical_scene_and_data
from tests.test_torch_incremental import _with_table


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs on several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pano(seed, H=64, W=128, C=3):
    """A smooth float panorama in [0, 1] that wraps around in x."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / np.array([H, W])[:, None, None]
    out = np.zeros((H, W, C))
    for c in range(C):
        for _ in range(4):
            k, ph, amp = rng.integers(1, 4), rng.uniform(0, 2 * np.pi), rng.uniform(0.05, 0.15)
            out[..., c] += amp * np.sin(2 * np.pi * k * xx + ph) * np.cos(np.pi * yy * k)
    return (0.5 + out).astype(np.float32)


@pytest.mark.parametrize("out_size,focal", [(24, 12.0), (40, 30.0)])
def test_sample_pinhole_from_equirect(out_size, focal):
    pano = _pano(0)
    R = expmap_np(np.array([0.3, -1.2, 0.4]))
    ref = np.asarray(jsph.sample_pinhole_from_equirect(pano, R, focal, out_size))
    got = tsph.sample_pinhole_from_equirect(torch.as_tensor(pano), R, focal, out_size).numpy()
    assert got.shape == ref.shape == (out_size, out_size, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("out_size", [None, 20])
def test_spherical_to_cubic(out_size):
    pano = _pano(1)[..., 0]
    fr, rr, focal_r = jsph.spherical_to_cubic(pano, out_size)
    ft, rt, focal_t = tsph.spherical_to_cubic(torch.as_tensor(pano), out_size)
    assert focal_t == focal_r
    np.testing.assert_allclose(rt, rr, atol=1e-12)
    np.testing.assert_allclose(ft.numpy(), fr, atol=1e-4)


def test_cubify_through_both_clis(tmp_path):
    pano = (_pano(2, H=48, W=96) * 255).astype(np.uint8)
    imgs = tmp_path / "images"
    imgs.mkdir()
    for v in range(2):
        write_image(str(imgs / f"pano{v}.png"), np.roll(pano, 17 * v, axis=1))
    s, sc, _, _ = spherical_ring_scene(n_views=2, n_points=4, width=96, height=48)
    sc.view_filename = ["pano0.png", "pano1.png"]
    sc.root_path = str(imgs)
    sfm = str(tmp_path / "sfm_data.json")
    save_sfm_data(sc, sfm)
    assert jcli.main(["cubify", "-i", sfm, "-o", str(tmp_path / "ref")]) == 0
    assert tcli.main(["cubify", "-i", sfm, "-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 12
    for n in names:
        a = read_image(str(tmp_path / "ref" / n)).astype(int)
        b = read_image(str(tmp_path / "port" / n)).astype(int)
        assert a.shape == b.shape == (24, 24, 3)
        assert np.abs(a - b).max() <= 1, n


def test_ring_scene_copy_matches_the_reference_test():
    ref = _spherical_scene_and_data(seed=3)
    got = spherical_ring_scene(seed=3)
    for a, b in zip(ref[0], got[0]):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-12)
    for a, b in zip(ref[2], got[2]):
        np.testing.assert_allclose(b, a, atol=1e-9)
    assert sorted(ref[3]) == sorted(got[3])
    for k in ref[3]:
        np.testing.assert_array_equal(got[3][k], ref[3][k])
    sc = from_reference(ref[1])
    for f in ("view_filename", "view_intrinsic", "view_pose", "view_wh", "pose_valid"):
        np.testing.assert_array_equal(np.asarray(getattr(got[1], f)), np.asarray(getattr(sc, f)))
    for f in got[1].cameras._fields:
        np.testing.assert_array_equal(getattr(got[1].cameras, f), getattr(sc.cameras, f))


def test_resection_angular_same_draws_same_result(monkeypatch):
    """The angular P3P AC-RANSAC of a spherical view on one Gumbel table."""
    s, sc, feats, _ = spherical_ring_scene(n_views=4, n_points=90, seed=5)
    v = 2
    Xc = s.X @ s.R[v].T + s.t[v]
    b = Xc / np.linalg.norm(Xc, axis=1, keepdims=True)
    rng = np.random.default_rng(11)
    b = b + rng.normal(scale=2e-4, size=b.shape)
    b[::6] = rng.normal(size=(len(b[::6]), 3))
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    n_samples = 128
    table = np.random.default_rng(12).gumbel(size=(n_samples, len(b)))
    _with_table(monkeypatch, table, n_samples * 9 // 10)
    ref = jax.jit(jrobust.robust_resection_angular, static_argnames="n_samples")(
        jax.random.PRNGKey(0), jnp.asarray(b), jnp.asarray(s.X), jnp.ones(len(b), bool),
        n_samples=n_samples)
    got = trobust.robust_resection_angular_batch(
        None, torch.as_tensor(b)[None], torch.as_tensor(s.X)[None],
        torch.ones((1, len(b)), dtype=torch.bool), n_samples=n_samples,
        gumbel=torch.as_tensor(table)[None])
    assert bool(got.found[0]) and bool(ref.found)
    np.testing.assert_array_equal(got.inliers[0].numpy(), np.asarray(ref.inliers))
    for a, r in zip(got.model, ref.model):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(r), atol=1e-6)
    np.testing.assert_allclose(got.model[0][0].numpy(), s.R[v], atol=1e-3)


def _aligned(C, gt):
    sim = find_rts(jnp.asarray(C[None]), jnp.asarray(gt[None]))
    return np.asarray(sim.apply(jnp.asarray(C[None])))[0]


@pytest.mark.parametrize("engine", ["INCREMENTAL", "GLOBAL"])
def test_spherical_engine_against_reference(engine):
    """The reference test's scenes and configurations (seed 0 for
    INCREMENTAL, 4 for GLOBAL), on both packages."""
    s, jsc, feats, matches = _spherical_scene_and_data(seed=0 if engine == "INCREMENTAL" else 4)
    tsc = from_reference(jsc)
    if engine == "INCREMENTAL":
        kw = dict(init_pair_samples=512, ransac_samples=512, resection_samples=512,
                  min_init_inliers=40, ba_iterations=15)
        jincremental(jsc, feats, matches, JIncConfig(**kw), seed=0)
        tincremental(tsc, feats, matches, TIncConfig(**kw), seed=0, device="cpu")
    else:
        jG.global_sfm(jsc, feats, matches, jG.GlobalConfig(ransac_samples=512, ba_iterations=15),
                      seed=0)
        tG.global_sfm(tsc, feats, matches, tG.GlobalConfig(ransac_samples=512, ba_iterations=15),
                      seed=0, device="cpu")
    assert int(np.sum(jsc.pose_valid)) == int(tsc.pose_valid.sum()) == s.n_views
    assert tsc.n_landmarks > 100
    ref = _aligned(np.asarray(jsc.pose_C), s.C)
    got = _aligned(tsc.pose_C, s.C)
    assert np.abs(got - ref).max() < 1e-3
    assert np.linalg.norm(got - s.C, axis=1).max() < 0.05 * 2.0


def test_triangulation_behind_the_optical_axis():
    """A SPHERICAL view sees the points behind its optical axis: the port's
    cheirality is the depth along the bearing (openMVG's CheiralityTest), so
    a point with camera z < 0 triangulates.  The reference tests the camera
    z and refuses it (ROADMAP.md, fault 3.4); on points in front of pinhole
    cameras both keep the same points."""
    from openmvg_tpu.ops.triangulation import triangulate_nview as jtri
    from openmvg_torch.ops.triangulation import triangulate_nview as ttri

    s = spherical_ring_scene(n_views=3, n_points=1, seed=0)[0]
    X = np.array([[0.3, 0.2, 5.0], [-4.0, 0.5, 0.5], [0.1, -0.3, -6.0], [0.2, 0.1, 0.05]])
    Xc = np.einsum("vij,pj->pvi", s.R, X) + s.t[None]
    b = Xc / np.linalg.norm(Xc, axis=-1, keepdims=True)
    R = np.ascontiguousarray(np.broadcast_to(s.R, (len(X), 3, 3, 3)))
    t = np.ascontiguousarray(np.broadcast_to(s.t, (len(X), 3, 3)))
    Xt, ok = ttri(torch.as_tensor(R), torch.as_tensor(t), torch.as_tensor(b))
    assert ok.all() and (Xc[..., 2] < 0).any()
    np.testing.assert_allclose(Xt.numpy(), X, atol=1e-9)
    _, ok_ref = jtri(jnp.asarray(R), jnp.asarray(t), jnp.asarray(b))
    front = (Xc[..., 2] > 0).all(-1)
    np.testing.assert_array_equal(np.asarray(ok_ref), front)
    # a point behind every bearing is refused by both
    _, ok_back = ttri(torch.as_tensor(R), torch.as_tensor(t), torch.as_tensor(-b))
    assert not ok_back.any()


def test_spherical_residual_wraps_at_the_seam():
    """A point just across an equirectangular view's seam from its
    observation is a few pixels off, not a whole image width: the port
    takes a SPHERICAL view's x difference modulo one turn, in the BA's
    residual and in the host's (ROADMAP.md, fault 3.5); the reference
    subtracts the pixels as they are.  Pinhole residuals are unchanged."""
    from openmvg_tpu.models import cameras as jcm
    from openmvg_torch.models import cameras as cm
    from openmvg_torch.utils.hostmath import project_cam_np, residual_np

    W, H = 2048.0, 1024.0
    # behind the camera, a little to either side of the seam (lon = +-pi)
    Xc = np.array([[1e-3, 0.1, -1.0], [-1e-3, 0.1, -1.0], [0.2, -0.1, 1.0]])
    kind = np.array([cm.SPHERICAL, cm.SPHERICAL, cm.SPHERICAL])
    params = np.zeros((3, cm.MAX_PARAMS))
    wh = (np.full(3, W), np.full(3, H))
    px = project_cam_np(kind, params, *wh, Xc)
    obs = px[[1, 0, 2]]                      # each seam point observed across it
    assert abs(px[0, 0] - px[1, 0]) > W - 2
    want = np.array([[px[0, 0] - px[1, 0] - W, px[0, 1] - px[1, 1]],
                     [px[1, 0] - px[0, 0] + W, px[1, 1] - px[0, 1]], [0.0, 0.0]])
    r_host = residual_np(kind, params, *wh, Xc, obs)
    r_dev = cm.residual(*(torch.as_tensor(a) for a in (kind, params, *wh, Xc, obs))).numpy()
    np.testing.assert_allclose(r_host, want, atol=1e-9)
    np.testing.assert_allclose(r_dev, want, atol=1e-9)
    assert np.abs(r_host).max() < 2.0
    r_ref = np.asarray(jcm.residual(*(jnp.asarray(a) for a in (kind, params, *wh, Xc, obs))))
    assert np.abs(r_ref[:2, 0]).min() > W - 2
    # pinhole: project - observed, as the reference
    pk = np.full(3, cm.PINHOLE)
    pp = np.tile([[800.0, W / 2, H / 2, 0, 0, 0, 0, 0]], (3, 1))
    Xf = np.abs(Xc) + [0.0, 0.0, 1.0]
    r_pin = residual_np(pk, pp, *wh, Xf, obs)
    np.testing.assert_allclose(r_pin, project_cam_np(pk, pp, *wh, Xf) - obs, atol=1e-9)
    np.testing.assert_allclose(
        cm.residual(*(torch.as_tensor(a) for a in (pk, pp, *wh, Xf, obs))).numpy(), r_pin,
        atol=1e-9)


def test_spherical_room_short_tracks(tmp_path):
    """INCREMENTAL on a small short-track room (60 views of 4096 x 2048,
    each point seen by its 5 to 17 nearest views, mostly behind the camera
    and around the seam, 0.5 px noise): every pose, landmarks that keep
    their tracks (grown observations of views behind their optical axis,
    fault 3.5), and positions within 0.2% of the ring radius after 7-DoF
    alignment.  Before the repair the landmarks kept about 3 observations
    of 11 and the positions drifted by 0.009."""
    from openmvg_torch.io.matches_io import load_matches
    from openmvg_torch.io.sfm_data import load_sfm_data
    from openmvg_torch.sfm.eval_quality import evaluate_against_gt
    from openmvg_torch.sfm.scene import Scene, rmse
    from openmvg_torch.utils.synthetic import spherical_room_dataset

    n = 60
    sfm, md, R, C = spherical_room_dataset(str(tmp_path), n_views=n, width=4096, height=2048,
                                           n_obs=9000, outlier_share=0.0, seed=3)
    sc = load_sfm_data(sfm)
    feats, _ = tcli._load_features_for_scene(sc, md)
    matches = load_matches(os.path.join(md, "matches.putative.bin"))
    tincremental(sc, feats, matches, TIncConfig(ransac_samples=256, resection_samples=256,
                                                init_pair_samples=512), seed=0, device="cpu")
    gt = Scene(view_filename=[f"v{i}.jpg" for i in range(n)],
               view_pose=np.arange(n, dtype=np.int32), view_intrinsic=np.zeros(n, np.int32),
               pose_valid=np.ones(n, bool), pose_R=R, pose_C=C)
    stats = evaluate_against_gt(sc, gt)
    assert int(sc.pose_valid.sum()) == n
    assert sc.obs_valid.sum() / sc.n_landmarks > 8.0
    assert rmse(sc) < 1.0
    assert stats["position_rmse"] <= 0.004


def test_spherical_room_dataset(tmp_path):
    """The card phase's scene generator at a small size: views, features
    and putative matches in the reference's files, every pair within 3
    ring steps, features inside the panorama, tracks of 5 to 17 views,
    and (without pixel noise) every match on its epipolar curve but the
    asked share of outliers."""
    from openmvg_torch.io.features_io import load_feats
    from openmvg_torch.io.matches_io import load_matches
    from openmvg_torch.io.sfm_data import load_sfm_data
    from openmvg_torch.utils.synthetic import spherical_room_dataset

    n, W, H = 24, 1024, 512
    sfm, md, R, C = spherical_room_dataset(str(tmp_path), n_views=n, width=W, height=H,
                                           n_obs=4000, noise_px=0.0, outlier_share=0.1, seed=1)
    sc = load_sfm_data(sfm)
    assert sc.n_views == n and list(sc.cameras.kind) == [cm_spherical()]
    feats = [load_feats(os.path.join(md, f"v{v}.feat")) for v in range(n)]
    assert 3500 < sum(map(len, feats)) < 4500
    for f in feats:
        assert (f[:, 0] >= 0).all() and (f[:, 0] < W).all()
        assert (f[:, 1] > -3).all() and (f[:, 1] < H + 3).all()
    m = load_matches(os.path.join(md, "matches.putative.bin"))
    from openmvg_torch.sfm.tracks import build_tracks

    clean = spherical_room_dataset(str(tmp_path / "clean"), n_views=n, width=W, height=H,
                                   n_obs=4000, noise_px=0.0, outlier_share=0.0, seed=1)[1]
    tracks = build_tracks(load_matches(os.path.join(clean, "matches.putative.bin")), 2)
    length = np.bincount(tracks.track_id)
    assert length.min() >= 5 and length.max() <= 17
    assert all(min(j - i, n - (j - i)) <= 3 for i, j in m)
    assert all(x[:, 0].max() < len(feats[i]) and x[:, 1].max() < len(feats[j])
               for (i, j), x in m.items())
    # the share of matches off their epipolar curve is the outlier share
    from openmvg_torch.models import cameras as cm

    off = tot = 0
    for (i, j), x in m.items():
        def bearings(v, idx):
            n_ = len(idx)
            return cm.bearing(torch.full((n_,), cm.SPHERICAL), torch.zeros((n_, cm.MAX_PARAMS),
                              dtype=torch.float64), torch.full((n_,), float(W), dtype=torch.float64),
                              torch.full((n_,), float(H), dtype=torch.float64),
                              torch.as_tensor(feats[v][idx, :2])).numpy()

        bi, bj = bearings(i, x[:, 0]), bearings(j, x[:, 1])
        Rr = R[j] @ R[i].T
        tr = R[j] @ (C[i] - C[j])
        E = np.array([[0, -tr[2], tr[1]], [tr[2], 0, -tr[0]], [-tr[1], tr[0], 0]]) @ Rr
        off += int((np.abs(np.einsum("ni,ij,nj->n", bj, E, bi)) > 1e-9).sum())
        tot += len(x)
    assert 0.09 < off / tot < 0.11


def cm_spherical():
    from openmvg_torch.models import cameras as cm

    return cm.SPHERICAL
