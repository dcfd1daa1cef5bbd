"""Port parity for FAST, KLT and monocular VO (openmvg_torch/ops/fast.py
and sfm/vo.py against openmvg_tpu's), on the same numpy inputs, on the
CPU.  fast_detect: the same corners in the same order and scores within
1e-6 (the sums of absolute differences are added in circle order on both
sides).  klt_track: the same ok flags and positions within 1e-3 px.
MonocularVO and `vo` through both CLIs on the reference test's sequence
(tests/test_fast_vo.py, sideways motion along +x): the same number of
poses, each step direction within 10 degrees of the reference's, and
within the reference test's gate of the true motion (x component > 0.9).
The two draw their relative poses from different random streams, and on
these 128^2 frames either lands up to about 8 degrees off the true
direction.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from openmvg_tpu import cli as jcli
from openmvg_tpu.ops import fast as jfast
from openmvg_tpu.sfm.vo import MonocularVO as JVO
from openmvg_torch import cli as tcli
from openmvg_torch.io.image import read_image, write_image
from openmvg_torch.ops import fast as tfast
from openmvg_torch.sfm.vo import MonocularVO as TVO
from tests.test_sift import blob_image


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs on several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u8_texture(seed, shape=(96, 120)):
    """An 8-bit image (float k / 255): its SAD scores tie often."""
    rng = np.random.default_rng(seed)
    img = ndimage.gaussian_filter(rng.uniform(0, 1, shape), 1.5)
    return (np.round((img - img.min()) / (img.max() - img.min()) * 255) / 255).astype(np.float32)


@pytest.mark.parametrize("case,threshold,max_corners", [
    ("u8", 0.08, 256), ("u8", 0.03, 64), ("u8_flat", 0.05, 512), ("blobs", 0.15, 64)])
def test_fast_detect_equal(case, threshold, max_corners):
    if case == "blobs":
        img = blob_image(96, 96, blobs=[(20.0, 30.0, 1.3), (50.0, 70.0, 1.3), (80.0, 40.0, 1.3)])
    else:
        img = _u8_texture(1 if case == "u8" else 2)
        if case == "u8_flat":
            img[30:60, 40:90] = 0.5            # plateaus: zero scores, ties by index
    xy, sc, ok = jfast.fast_detect(jnp.asarray(img), threshold=threshold,
                                   max_corners=max_corners)
    xt, st, okt = tfast.fast_detect(torch.as_tensor(img), threshold=threshold,
                                    max_corners=max_corners)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(ok))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xy))
    np.testing.assert_allclose(st.numpy(), np.asarray(sc), atol=1e-6)
    assert okt.sum() > 0


@pytest.mark.parametrize("shift", [(3.0, 2.0), (-6.5, 4.25), (11.0, -9.0)])
def test_klt_track(shift):
    rng = np.random.default_rng(0)
    blobs = [(float(rng.uniform(20, 70)), float(rng.uniform(20, 70)),
              float(rng.uniform(2, 4))) for _ in range(12)]
    img0 = blob_image(96, 96, blobs=blobs, noise=0.005, seed=1)
    img1 = blob_image(96, 96, blobs=[(y + shift[1], x + shift[0], s) for (y, x, s) in blobs],
                      noise=0.005, seed=2)
    pts = np.array([[x, y] for (y, x, s) in blobs] + [[1.0, 1.0], [94.0, 50.0]], np.float32)
    nj, okj = jfast.klt_track(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts))
    nt, okt = tfast.klt_track(torch.as_tensor(img0), torch.as_tensor(img1),
                              torch.as_tensor(pts))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-3)
    assert okt.sum() >= 8


def _sequence():
    """tests/test_fast_vo.py's synthetic frames: 250 blobs, the camera
    moving 0.08 along +x a frame."""
    rng = np.random.default_rng(3)
    n_pts = 250
    X = rng.uniform(-2, 2, size=(n_pts, 3))
    X[:, 2] = rng.uniform(4, 10, n_pts)
    focal, size = 120.0, 128
    K = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1.0]])
    intens = rng.uniform(0.4, 1.0, n_pts)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    frames = []
    for i in range(4):
        uv = (X - [0.08 * i, 0.0, 0.0])[:, :2] / X[:, 2:3] * focal + size / 2
        img = np.zeros((size, size), np.float32)
        for p in range(n_pts):
            u, v = uv[p]
            if -3 < u < size + 3 and -3 < v < size + 3:
                img += intens[p] * np.exp(-((yy - v) ** 2 + (xx - u) ** 2) / (2 * 1.8 ** 2))
        frames.append(np.clip(img, 0, 1))
    return K, frames


def _steps(traj):
    steps = np.diff(np.asarray(traj), axis=0)
    return steps / np.linalg.norm(steps, axis=1, keepdims=True)


def _angles_deg(a, b):
    return np.degrees(np.arccos(np.clip(np.sum(a * b, axis=1), -1.0, 1.0)))


def test_monocular_vo_same_steps():
    K, frames = _sequence()
    jvo = JVO(K, min_tracks=150, fast_threshold=0.04)
    tvo = TVO(K, min_tracks=150, fast_threshold=0.04, device="cpu")
    for img in frames:
        jvo.process(img)
        tvo.process(img)
    assert len(tvo.trajectory) == len(jvo.trajectory) >= 3
    sj, st = _steps(jvo.trajectory), _steps(tvo.trajectory)
    assert (st[:, 0] > 0.9).all(), st
    assert _angles_deg(sj, st).max() < 10.0


def test_vo_through_both_clis(tmp_path):
    _, frames = _sequence()
    d = tmp_path / "frames"
    d.mkdir()
    for i, img in enumerate(frames):
        write_image(str(d / f"f{i:02d}.png"), img)
    out = {}
    for pkg, main, extra in (("ref", jcli.main, []), ("port", tcli.main, ["--device", "cpu"])):
        path = str(tmp_path / f"traj_{pkg}.txt")
        assert main(["vo", "-i", str(d), "-o", path, "-f", "120", "-t", "0.04"] + extra) == 0
        out[pkg] = np.loadtxt(path, ndmin=2)
    assert out["port"].shape == out["ref"].shape and len(out["port"]) >= 3
    assert (_steps(out["port"])[:, 0] > 0.9).all()
    assert _angles_deg(_steps(out["ref"]), _steps(out["port"])).max() < 10.0
    assert read_image(str(d / "f00.png"), grayscale=True).shape == (128, 128)
    assert os.path.getsize(tmp_path / "traj_port.txt") > 0


@pytest.mark.parametrize("argv", [["features", "-i", "sfm.json", "-o", "m", "-m", "AKAZE_FLOAT"],
                                  ["features", "-i", "sfm.json", "-o", "m", "-m", "AKAZE_MLDB"],
                                  ["cubify", "-i", "sfm.json", "-o", "faces"],
                                  ["vo", "-i", "frames", "-o", "traj.txt"]])
def test_new_commands_ask_for_the_card(argv, tmp_path, monkeypatch):
    """Without --device the new commands run on cuda, and raise without a
    card instead of running on the CPU (nothing is read or written)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(argv)
    assert not os.listdir(tmp_path)
