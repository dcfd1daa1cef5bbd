"""The port's GPS registration, clustering, colour harmonisation and rerun
logging against the reference's: the LMedS similarity with the
reference's sample table carried across (an equal model), cluster_views
and the cluster CLI from the same initial centres (through the
kmeans_pp_init hook, as the VLAD tests do; equal clusters), the
harmonisation's gains and offsets within 1e-9 and the harmonize CLI's
pixels equal, and log_scene's calls on a stand-in rerun module."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openmvg_tpu import cli as jcli
from openmvg_tpu.geometry.so3 import expmap
from openmvg_tpu.io.features_io import save_descs, save_feats
from openmvg_tpu.io.matches_io import save_matches
from openmvg_tpu.io.sfm_data import save_sfm_data
from openmvg_tpu.models import cameras as jcm
from openmvg_tpu.ops import ransac as jransac
from openmvg_tpu.ops import vlad as jvlad
from openmvg_tpu.sfm import clustering as jclu
from openmvg_tpu.sfm import color_harmonization as jch
from openmvg_tpu.sfm import gps_registration as jgps
from openmvg_tpu.sfm.scene import Scene as JScene
from openmvg_tpu.utils import rerun_viewer as jrr
from openmvg_tpu.utils.synthetic import ring_scene
from openmvg_torch import cli
from openmvg_torch.io import from_reference
from openmvg_torch.io.image import read_image, write_image
from openmvg_torch.io.sfm_data import load_sfm_data
from openmvg_torch.ops import vlad as tvlad
from openmvg_torch.sfm import clustering as tclu
from openmvg_torch.sfm import color_harmonization as tch
from openmvg_torch.sfm import gps_registration as tgps
from openmvg_torch.utils import rerun_viewer as trr
from tests.test_ba import scene_from_ring

DEV = ["--device", "cpu"]


def _planted(seed=3, n=12, n_out=3):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(n, 3))
    R = np.asarray(expmap(jnp.asarray([0.1, -0.2, 0.3])))
    dst = 2.5 * src @ R.T + np.array([10.0, -5.0, 2.0])
    dst[:n_out] += rng.normal(scale=5.0, size=(n_out, 3))
    return src, dst


def test_lmeds_similarity_same_draws():
    src, dst = _planted()
    key = jax.random.PRNGKey(4)
    ref = jgps.fit_similarity_lmeds(src, dst, key=key)
    idx = np.asarray(jransac.draw_samples(key, 256, 3, jnp.ones(len(src))))
    got = tgps.fit_similarity_lmeds(src, dst, idx=idx, device="cpu")
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-9)
    assert abs(float(got.scale) - 2.5) < 1e-9


def test_lmeds_with_own_draws_and_register():
    """With its own draws the port finds the planted similarity (3 of 12
    correspondences outliers); register_to_gps moves the scene onto the
    priors."""
    src, dst = _planted()
    sim = tgps.fit_similarity_lmeds(src, dst, device="cpu")
    assert abs(float(sim.scale) - 2.5) < 1e-9
    sc = from_reference(scene_from_ring(ring_scene(n_views=6, n_points=40, seed=0), seed=1))
    R = np.asarray(expmap(jnp.asarray([0.1, -0.2, 0.3])))
    sc.prior_center = 2.5 * sc.pose_C @ R.T + np.array([10.0, -5.0, 2.0])
    sc.prior_center_weight = np.ones((6, 3))
    prior = sc.prior_center.copy()
    sc, _ = tgps.register_to_gps(sc, device="cpu")
    np.testing.assert_allclose(sc.pose_C, prior, atol=1e-9)


def _first_rows(key_or_gen, X, k):
    return X[:k]


@pytest.fixture
def same_init(monkeypatch):
    monkeypatch.setattr(jvlad, "kmeans_pp_init", _first_rows)
    monkeypatch.setattr(tvlad, "kmeans_pp_init", _first_rows)


def test_cluster_views_same_init(same_init):
    jsc = scene_from_ring(ring_scene(n_views=12, n_points=40, seed=0), seed=1)
    tsc = from_reference(jsc)
    for k in (2, 3):
        ref = jclu.cluster_views(jsc, k)
        got = tclu.cluster_views(tsc, k, device="cpu")
        assert got == ref
        for views in got:
            a, b = tclu.scene_for_views(tsc, views), jclu.scene_for_views(jsc, views)
            assert np.array_equal(a.obs_valid, b.obs_valid)
            assert np.array_equal(a.pose_valid, b.pose_valid)


def test_cluster_cli_same_init(same_init, tmp_path):
    jsc = scene_from_ring(ring_scene(n_views=12, n_points=40, seed=0), seed=1)
    sp = str(tmp_path / "sfm_data.json")
    save_sfm_data(jsc, sp)
    trees = []
    for side, main, extra in (("ref", jcli.main, []), ("port", cli.main, DEV)):
        out = str(tmp_path / side)
        assert main(["cluster", "-i", sp, "-o", out, "-n", "3"] + extra) == 0
        names = sorted(os.listdir(out))
        trees.append({n: (load_sfm_data(os.path.join(out, n)).obs_valid.tobytes(),
                          load_sfm_data(os.path.join(out, n)).pose_valid.tobytes())
                      for n in names})
    assert trees[0] == trees[1] and len(trees[0]) == 3


def test_split_matches_by_component():
    m = {(0, 1): np.ones((5, 2), np.int64), (1, 2): np.ones((5, 2), np.int64),
         (4, 5): np.ones((5, 2), np.int64)}
    for n in (2, 3):
        a = tclu.split_matches_by_component(m, n)
        b = jclu.split_matches_by_component(m, n)
        assert [sorted(p) for p in a] == [sorted(p) for p in b]


def test_gain_offset_solve():
    rng = np.random.default_rng(0)
    base = rng.uniform(0.2, 0.8, 2000)
    samples = [np.clip(g * base + o, 0, 1) for g, o in [(1.0, 0.0), (1.3, -0.05), (0.8, 0.1)]]
    pair_data = {(i, j): jch.pair_quantiles(samples[i], samples[j])
                 for i, j in [(0, 1), (1, 2), (0, 2)]}
    for k, v in pair_data.items():
        for a, b in zip(tch.pair_quantiles(samples[k[0]], samples[k[1]]), v):
            np.testing.assert_allclose(a, b, rtol=1e-9)
    for a, b in zip(tch.solve_gain_offset(3, pair_data, ref_image=1),
                    jch.solve_gain_offset(3, pair_data, ref_image=1)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)
    ims = [rng.random((4, 4, 3)) for _ in range(2)]
    for a, b in zip(tch.harmonize_images(ims, [1.1, 0.9], [0.01, -0.02]),
                    jch.harmonize_images(ims, [1.1, 0.9], [0.01, -0.02])):
        np.testing.assert_array_equal(a, b)


def test_harmonize_cli_same_pixels(tmp_path, capsys):
    """Three views, two of them gain/offset copies of the first: both CLIs
    print the same gains and offsets (to their 3 printed decimals) and
    write the same pixels within 1 gray level (the port through its own
    PNG writer).  The two solves gauge the IRLS differently (ROADMAP.md,
    fault 3.6), so they agree to rounding, not bit for bit."""
    rng = np.random.default_rng(0)
    size, n = 64, 3
    base = rng.uniform(0.2, 0.8, size=(size, size, 3))
    imgdir = tmp_path / "imgs"
    imgdir.mkdir()
    sc = JScene()
    sc.root_path = str(imgdir)
    sc.view_filename = [f"im{v}.png" for v in range(n)]
    sc.view_intrinsic = np.zeros(n, np.int32)
    sc.view_pose = np.arange(n, dtype=np.int32)
    sc.view_wh = np.tile([[size, size]], (n, 1)).astype(np.int32)
    sc.cameras = jcm.make_pinhole(size, size, 100.0, size / 2, size / 2)
    for v, (g, o) in enumerate([(1.0, 0.0), (1.25, -0.05), (0.8, 0.08)]):
        write_image(str(imgdir / f"im{v}.png"), np.clip(g * base + o, 0, 1))
    save_sfm_data(sc, str(tmp_path / "sfm_data.json"))
    gx, gy = np.meshgrid(np.arange(4, size - 4, 3), np.arange(4, size - 4, 3))
    xy = np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float64)
    mdir = tmp_path / "matches"
    mdir.mkdir()
    for v in range(n):
        save_feats(str(mdir / f"im{v}.feat"), np.concatenate([xy, np.ones((len(xy), 2))], 1))
        save_descs(str(mdir / f"im{v}.desc"), np.zeros((len(xy), 128), np.uint8))
    ident = np.stack([np.arange(len(xy))] * 2, 1)
    save_matches({(0, 1): ident, (0, 2): ident, (1, 2): ident}, str(mdir / "matches.f.bin"))
    outs = []
    for side, main, extra in (("ref", jcli.main, []), ("port", cli.main, DEV)):
        out = tmp_path / side
        capsys.readouterr()
        assert main(["harmonize", "-i", str(tmp_path / "sfm_data.json"),
                     "-m", str(mdir / "matches.f.bin"), "-o", str(out), "-r", "0"] + extra) == 0
        printed = capsys.readouterr().out.replace(str(out), "<out>")
        nums = [float(x) for b in re.findall(r"\[(.*?)\]", printed)
                for x in re.findall(r"-?\d+\.\d*", b)]
        outs.append((nums, [read_image(str(out / f"im{v}.png")).astype(int) for v in range(n)]))
    assert len(outs[0][0]) == len(outs[1][0]) == 18
    np.testing.assert_allclose(outs[1][0], outs[0][0], atol=1.5e-3)
    for a, b in zip(outs[0][1], outs[1][1]):
        assert np.abs(a - b).max() <= 1


def test_rerun_log_scene_same_calls():
    """log_scene on a stand-in rerun module: the same entities and values."""
    jsc = scene_from_ring(ring_scene(n_views=6, n_points=40, seed=0), seed=1)

    def fake():
        calls = []

        class Obj:
            def __init__(self, *a, **k):
                self.a, self.k = a, k

        class RR:
            class ViewCoordinates:
                RDF = "RDF"
            Points3D = Transform3D = Pinhole = Quaternion = EncodedImage = Obj

            @staticmethod
            def log(entity, *a, **k):
                calls.append((entity, a, k))
        return RR, calls

    def flat(calls):
        out = []
        for ent, a, k in calls:
            obj = a[0]
            vals = [np.asarray(x, np.float64).ravel() for x in getattr(obj, "a", ())]
            for key in sorted(getattr(obj, "k", {})):
                v = obj.k[key]
                v = getattr(v, "k", {}).get("xyzw", v)
                vals.append(np.asarray(v, np.float64).ravel())
            out.append((ent, np.concatenate(vals) if vals else np.zeros(0), k))
        return out

    (jrrm, jc), (trrm, tc) = fake(), fake()
    assert jrr.log_scene(jsc, jrrm) == trr.log_scene(from_reference(jsc), trrm)
    for (e1, v1, k1), (e2, v2, k2) in zip(flat(jc), flat(tc)):
        assert e1 == e2 and k1 == k2
        np.testing.assert_allclose(v1, v2, rtol=1e-6)
    assert len(jc) == len(tc) == 1 + 1 + 2 * 6


def _ring_pairs(n, seed, sat=1.5, noise=0.1):
    """Quantiles of a ring of n views, each matched to its next 6, 600
    samples a pair of a clipped texture (about a third of the samples at 0
    or 1, as at keypoints of the rendered sphere; 0.1 of sampling noise on
    each side), every tenth view under a
    planted gain in [0.8, 1.2] and offset in [-0.05, 0.05]."""
    rng = np.random.default_rng(seed)
    g_true, o_true = np.ones(n), np.zeros(n)
    pl = rng.choice(np.arange(1, n), n // 10, replace=False)
    g_true[pl], o_true[pl] = rng.uniform(0.8, 1.2, len(pl)), rng.uniform(-0.05, 0.05, len(pl))
    base = np.clip(rng.normal(0.5, 0.42 * sat, 5000), 0, 1)
    pair_data = {}
    for i in range(n):
        for d in range(1, 7):
            a, b = sorted((i, (i + d) % n))
            x = base[rng.choice(5000, 600)]
            xa = np.clip(x + rng.normal(0, noise, 600), 0, 1)
            xb = np.clip(x + rng.normal(0, noise, 600), 0, 1)
            pair_data[(a, b)] = tch.pair_quantiles(np.clip(g_true[a] * xa + o_true[a], 0, 1),
                                                   np.clip(g_true[b] * xb + o_true[b], 0, 1))
    return pair_data, g_true, o_true


def test_gain_offset_on_a_ring_of_100():
    """Fault 3.6: on a ring of 100 views with clipped samples the
    reference's solve (the reference image alone as gauge, clipped
    quantiles kept) sends every other gain to its 1e-3 floor; the port's
    undoes the planted gains and offsets within 0.05 and leaves the other
    gains within 0.05 of 1."""
    pair_data, g_true, o_true = _ring_pairs(100, 0)
    gj, _ = jch.solve_gain_offset(100, pair_data, ref_image=0)
    assert np.abs(gj - 1 / g_true).max() > 0.5
    g, o = tch.solve_gain_offset(100, pair_data, ref_image=0)
    assert np.abs(g - 1 / g_true).max() < 0.05
    assert np.abs(o + o_true / g_true).max() < 0.05
