"""Port parity for AKAZE (openmvg_torch/ops/akaze.py against
openmvg_tpu/ops/akaze.py) on the same numpy inputs, on the CPU, at 128^2
with 3 octaves, the reference tests' size.

The port computes in float32, as the reference does on its TPU; under x64
the reference's Hessian responses and sample grids are float64.  Stated
tolerances: the FED series exactly; scale-space levels within 1e-5;
keypoints the same set, ordered by (response, index), positions within
1e-3 px and responses within 1e-4 relative; orientations within 1e-5 rad;
MSURF within 1e-4; MLDB at most 1 bit in 1,000 flipped (each bit is a '>'
between float cell means).  Features are paired by position and scale
before they are compared: near-equal responses of the two precisions can
swap places in the strongest-first order.  On an exactly mirror-symmetric
image (the reference tests' noise-free blobs) a maximum can sit on two
mirror twins of equal response, and which of them pass the 3x3 test is the
rounding of each package's blur: there each keypoint of one package has
one of the other at the same level with a response within 1e-4 relative,
within 3.5 px (twins lie up to 2 px apart before the +-1 px refinement).  describe_image and `features -m AKAZE_FLOAT |
AKAZE_MLDB` through both CLIs: the same image_describer.json, .feat and
.desc (the reference's float64 .desc cast to float32) within those
tolerances.  Both packages' `matches` reads every .desc as 128 bytes a
feature, so both raise ValueError on AKAZE output.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage
from scipy.spatial import cKDTree

from openmvg_tpu import cli as jcli
from openmvg_tpu.io.features_io import load_descs as jload_descs
from openmvg_tpu.ops import akaze as ja
from openmvg_tpu.sfm import describer as jdescriber
from openmvg_torch import cli as tcli
from openmvg_torch.io.features_io import load_descs, load_feats
from openmvg_torch.io.image import write_image
from openmvg_torch.ops import akaze as ta
from openmvg_torch.sfm import describer as tdescriber
from tests.test_sift import blob_image

CFG = dict(n_octaves=3, max_per_octave=256)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs on several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _textured(seed, size=128):
    rng = np.random.default_rng(seed)
    img = ndimage.gaussian_filter(rng.uniform(0, 1, (size, size)), 2.0)
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


IMAGES = {
    "blobs_noise": lambda: blob_image(blobs=[(50, 60, 5.0), (80, 40, 4.0)], noise=0.01),
    "textured": lambda: _textured(0),
}
SYMMETRIC = lambda: blob_image(blobs=[(40.0, 50.0, 4.0), (90.0, 80.0, 8.0)])  # noqa: E731


def test_fed_tau_series_exact():
    for T in (0.1, 0.5, 1.2, 3.7, 12.0):
        assert ta._fed_tau_series(T) == ja._fed_tau_series(T)


@pytest.mark.parametrize("name", sorted(IMAGES) + ["symmetric"])
def test_scale_space_levels(name):
    img = IMAGES[name]() if name in IMAGES else SYMMETRIC()
    oj, sj = ja.build_nonlinear_scale_space(jnp.asarray(img), ja.AkazeConfig(**CFG))
    ot, st = ta.build_nonlinear_scale_space(torch.as_tensor(img), ta.AkazeConfig(**CFG))
    for a, b, c, d in zip(oj, ot, sj, st):
        np.testing.assert_array_equal(d, c)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


def _ordered(kp, n_cols):
    """Valid keypoints ordered by (response descending, flat index)."""
    v = np.asarray(kp["valid"])
    val = np.asarray(kp["value"], np.float64)[v]
    lvl = np.asarray(kp["level"])[v]
    y, x = np.asarray(kp["y"], np.float64)[v], np.asarray(kp["x"], np.float64)[v]
    flat = (lvl * 10 ** 6 + np.rint(y) * n_cols + np.rint(x)).astype(np.int64)
    o = np.lexsort((flat, -val))
    return val[o], lvl[o], y[o], x[o]


def _octave_keypoints(img):
    cj, ct = ja.AkazeConfig(**CFG), ta.AkazeConfig(**CFG)
    oj, sj = ja.build_nonlinear_scale_space(jnp.asarray(img), cj)
    ot, _ = ta.build_nonlinear_scale_space(torch.as_tensor(img), ct)
    for o in range(cj.n_octaves):
        kj = ja._detect_octave(oj[o], sj[o], 2.0 ** o, cj)
        kt = ta._detect_octave(ot[o], sj[o], 2.0 ** o, ct)
        yield _ordered(kj, oj[o].shape[-1]), _ordered(kt, ot[o].shape[-1])


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_keypoints_same_set(name):
    n_kp = 0
    for rj, rt in _octave_keypoints(IMAGES[name]()):
        assert len(rj[0]) == len(rt[0])
        np.testing.assert_allclose(rt[0], rj[0], rtol=1e-4)
        np.testing.assert_array_equal(rt[1], rj[1])
        np.testing.assert_allclose(rt[2], rj[2], atol=1e-3)
        np.testing.assert_allclose(rt[3], rj[3], atol=1e-3)
        n_kp += len(rj[0])
    assert n_kp > 0


def test_keypoints_on_a_symmetric_image():
    n_kp = 0
    for rj, rt in _octave_keypoints(SYMMETRIC()):
        for a, b in ((rj, rt), (rt, rj)):
            for val, lvl, y, x in zip(*a):
                near = (b[1] == lvl) & (np.hypot(b[2] - y, b[3] - x) < 3.5) & \
                    (np.abs(b[0] - val) <= 1e-4 * abs(val))
                assert near.any(), (lvl, y, x, val)
        n_kp += len(rj[0])
    assert n_kp > 0


def _check_features(fj, dj, ft, dt):
    assert ft.shape == fj.shape and dt.shape == dj.shape and len(fj) > 0
    # pair the rows by scale and position (every pairing within 1e-3 px)
    key = lambda f: np.c_[f[:, :2], 1e3 * f[:, 2]]  # noqa: E731
    dist, idx = cKDTree(key(fj)).query(key(ft))
    assert dist.max() < 1e-2 and len(set(idx.tolist())) == len(idx)
    fj, dj = fj[idx], dj[idx]
    np.testing.assert_allclose(ft[:, :3], fj[:, :3], atol=1e-3)
    np.testing.assert_allclose(ft[:, 3], fj[:, 3], atol=1e-5)
    if dt.dtype == np.uint8:
        flipped = int(np.unpackbits(dt ^ dj).sum())
        assert flipped <= 1e-3 * 360 * len(dt), flipped
        assert not np.unpackbits(dt, axis=1)[:, 360:].any()
    else:
        assert dt.dtype == np.float32 and dt.shape[1] == 64
        np.testing.assert_allclose(dt, dj, atol=1e-4)


@pytest.mark.parametrize("name", sorted(IMAGES))
@pytest.mark.parametrize("descriptor,upright", [("MSURF", False), ("MLDB", False),
                                                ("MSURF", True)])
def test_extract(name, descriptor, upright):
    img = IMAGES[name]()
    kw = dict(CFG, descriptor=descriptor, upright=upright)
    fj, dj = ja.extract_to_numpy(img, cfg=ja.AkazeConfig(**kw))
    ft, dt = ta.extract_to_numpy(img, cfg=ta.AkazeConfig(**kw), device="cpu")
    _check_features(fj, dj, ft, dt)
    if upright:
        assert (ft[:, 3] == 0).all()


@pytest.mark.parametrize("method", ["AKAZE_FLOAT", "AKAZE_MLDB"])
def test_describe_image(method):
    img = _textured(1)
    fj, dj = jdescriber.describe_image(img, method)
    ft, dt = tdescriber.describe_image(img, method, device="cpu")
    _check_features(fj, dj, ft, dt)


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    """Two textured 128^2 views listed by the port's init."""
    root = tmp_path_factory.mktemp("akaze_cli")
    imgs = root / "images"
    imgs.mkdir()
    for v in range(2):
        write_image(str(imgs / f"img_{v:02d}.png"), np.roll(_textured(7), 5 * v, axis=1))
    assert tcli.main(["init", "-i", str(imgs), "-o", str(root / "out"), "-f", "150",
                      "-c", "1", "--device", "cpu"]) == 0
    return root


@pytest.mark.parametrize("method", ["AKAZE_FLOAT", "AKAZE_MLDB"])
def test_features_and_matches_through_both_clis(tiny_scene, method):
    sfm = str(tiny_scene / "out" / "sfm_data.json")
    dirs = {k: str(tiny_scene / f"{k}_{method}") for k in ("ref", "port")}
    assert jcli.main(["features", "-i", sfm, "-o", dirs["ref"], "-m", method]) == 0
    assert tcli.main(["features", "-i", sfm, "-o", dirs["port"], "-m", method,
                      "--device", "cpu"]) == 0
    docs = [json.load(open(os.path.join(d, "image_describer.json"))) for d in dirs.values()]
    assert docs[0] == docs[1]
    assert docs[1]["regions_type"]["polymorphic_name"] == (
        "AKAZE_Float_Regions" if method == "AKAZE_FLOAT" else "AKAZE_Binary_Regions")
    dim, ref_dt, port_dt = (64, np.float64, np.float32) if method == "AKAZE_FLOAT" else \
        (60, np.uint8, np.uint8)
    for v in range(2):
        stem = f"img_{v:02d}"
        fj = load_feats(os.path.join(dirs["ref"], stem + ".feat"))
        ft = load_feats(os.path.join(dirs["port"], stem + ".feat"))
        dj = jload_descs(os.path.join(dirs["ref"], stem + ".desc"), dim, ref_dt)
        dt = load_descs(os.path.join(dirs["port"], stem + ".desc"), dim, port_dt)
        assert os.path.getsize(os.path.join(dirs["port"], stem + ".desc")) == \
            8 + len(ft) * dim * np.dtype(port_dt).itemsize
        _check_features(fj, dj.astype(port_dt), ft, dt)
    with open(os.path.join(dirs["port"], "pairs.txt"), "w") as f:
        f.write("0 1\n")
    for pkg, main, extra in (("ref", jcli.main, []), ("port", tcli.main, ["--device", "cpu"])):
        with pytest.raises(ValueError):
            main(["matches", "-i", sfm, "-o", os.path.join(dirs[pkg], "m.bin"),
                  "-p", os.path.join(dirs["port"], "pairs.txt")] + extra)
