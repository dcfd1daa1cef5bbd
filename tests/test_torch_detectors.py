"""Port parity for the other detectors and descriptors, openmvg_torch
against openmvg_tpu on the same numpy inputs, on the CPU: MSER regions
equal (a copy of the host code); TBMR's native component tree
(csrc/native.cpp omt_tbmr) equal to the reference's native one (the
same regions, centres and areas; the ellipse within 1e-9 relative, as the
reference builds with -march=native, which contracts to FMA in the
cancelling central moments) and to the plain _tbmr_python (within 1e-9);
LIOP and DIPOLE within
1e-5 of the reference's float32 descriptors, including a keypoint at the
border, an orientation sweep and the reference tests' rotation cases.
"""

import numpy as np
import pytest
from scipy import ndimage

from openmvg_tpu import native as jnative
from openmvg_tpu.ops import mser as jmser
from openmvg_tpu.ops import tbmr as jtbmr
from openmvg_tpu.ops.dipole import dipole_describe as jdipole
from openmvg_tpu.ops.liop import liop_describe as jliop
from openmvg_torch.ops import mser as tmser
from openmvg_torch.ops import tbmr as ttbmr
from openmvg_torch.ops.dipole import dipole_describe as tdipole
from openmvg_torch.ops.liop import liop_describe as tliop
from tests.test_tbmr_liop_dipole import _smooth_random_image, _two_blob_image


def _textured_u8(seed, size=(90, 110)):
    rng = np.random.default_rng(seed)
    img = ndimage.gaussian_filter(rng.uniform(0, 255, size), 2.5)
    img = (img - img.min()) / (img.max() - img.min()) * 255
    return np.clip(img, 0, 255).astype(np.uint8)


def _mser_image():
    img = np.full((120, 120), 0.8, np.float32)
    yy, xx = np.mgrid[0:120, 0:120]
    img[(yy - 40) ** 2 + (xx - 30) ** 2 < 12 ** 2] = 0.1
    img[((yy - 85) / 8.0) ** 2 + ((xx - 80) / 16.0) ** 2 < 1.0] = 1.0
    return img


@pytest.mark.parametrize("case", ["blobs", "textured"])
def test_mser_equal_regions(case):
    img = _mser_image() if case == "blobs" else _textured_u8(3)
    ref = jmser.detect_mser(img)
    got = tmser.detect_mser(img)
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert tuple(a) == tuple(b)


@pytest.mark.parametrize("invert", [0, 1])
@pytest.mark.parametrize("case", ["blobs", "textured", "textured_small_rel"])
def test_tbmr_native_equals_reference_and_plain(case, invert):
    img = _two_blob_image() if case == "blobs" else _textured_u8(1 if invert else 2)
    rel = 0.01 if case == "textured_small_rel" else 0.75
    got = ttbmr.tbmr_native(img, invert, 30, rel)
    ref = jnative.tbmr_native(img, invert, 30, rel)
    plain = ttbmr._tbmr_python(img, invert, 30, rel)
    assert ref is not None and len(got) > 0
    assert got.shape == ref.shape == plain.shape
    np.testing.assert_array_equal(got[:, [0, 1, 5]], ref[:, [0, 1, 5]])
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0)
    np.testing.assert_allclose(np.sort(got, axis=0), np.sort(plain, axis=0), atol=1e-9)


def test_detect_tbmr_regions_equal():
    img = _textured_u8(4)
    got = ttbmr.detect_tbmr(img, max_rel_size=0.2)
    ref = jtbmr.detect_tbmr(img, max_rel_size=0.2)
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a[:-1], np.float64), np.asarray(b[:-1], np.float64),
                                   atol=1e-12)
        assert a.dark == b.dark


def _keypoints(img, n=24, seed=0):
    rng = np.random.default_rng(seed)
    H, W = img.shape
    xy = np.c_[rng.uniform(0, W - 1, n), rng.uniform(0, H - 1, n)]
    xy[:3] = [[2.0, 2.0], [W - 1.5, 3.0], [0.0, H - 1.0]]           # at the border
    return xy, rng.uniform(0.8, 3.5, n), rng.uniform(-np.pi, np.pi, n)


def test_liop_equal():
    img = _smooth_random_image(5)
    xy, sc, _ = _keypoints(img)
    ref = np.asarray(jliop(img, xy, sc))
    got = tliop(img, xy, sc).numpy()
    assert got.shape == (len(xy), 144) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_liop_rotation_case():
    """tests/test_tbmr_liop_dipole.py's rotation-invariance case."""
    img = _smooth_random_image()
    xy = np.array([[64.0, 64.0], [40.0, 80.0], [90.0, 30.0]])
    sc = np.array([2.0, 1.5, 1.0])
    img_r = np.rot90(img, k=-1).copy()
    xy_r = np.stack([img.shape[1] - 1 - xy[:, 1], xy[:, 0]], axis=1)
    for im, p in ((img, xy), (img_r, xy_r)):
        np.testing.assert_allclose(tliop(im, p, sc).numpy(), np.asarray(jliop(im, p, sc)),
                                   atol=1e-5)


@pytest.mark.parametrize("smoothed", [True, False])
def test_dipole_equal(smoothed):
    img = _smooth_random_image(6)
    xy, sc, ori = _keypoints(img, seed=1)
    for o in (None, ori):
        ref = np.asarray(jdipole(img, xy, sc, orientation=o, smoothed=smoothed))
        got = tdipole(img, xy, sc, orientation=o, smoothed=smoothed).numpy()
        assert got.shape == (len(xy), 20)
        np.testing.assert_allclose(got, ref, atol=1e-5)


def test_dipole_rotation_and_luminance_cases():
    """tests/test_tbmr_liop_dipole.py's luminance and steering cases."""
    img = _smooth_random_image(3)
    xy, sc = np.array([[64.0, 64.0], [30.0, 70.0]]), np.array([2.5, 2.0])
    img_r = np.rot90(img, k=-1).copy()
    xy_r = np.array([[img.shape[1] - 1 - xy[0, 1], xy[0, 0]]])
    for im, p, s, o in ((1.7 * img + 25.0, xy, sc, None),
                        (img_r, xy_r, sc[:1], np.array([np.pi / 2]))):
        np.testing.assert_allclose(tdipole(im, p, s, orientation=o).numpy(),
                                   np.asarray(jdipole(im, p, s, orientation=o)), atol=1e-5)
