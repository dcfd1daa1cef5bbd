"""Port parity for the on-disk formats: .feat, .desc, matches.bin and
sfm_data .json/.bin/.xml written by one package are read by the other and
are byte for byte the same; the port's own PNG reader equals PIL."""

import os

import numpy as np
import pytest

from openmvg_tpu.io import features_io as jfio
from openmvg_tpu.io import image as jimage
from openmvg_tpu.io import matches_io as jmio
from openmvg_tpu.io import sfm_data as jsfm
from openmvg_tpu.models import cameras as jcm
from openmvg_tpu.sfm.scene import Scene as JScene
from openmvg_torch.io import features_io as tfio
from openmvg_torch.io import from_reference
from openmvg_torch.io import image as timage
from openmvg_torch.io import matches_io as tmio
from openmvg_torch.io import sfm_data as tsfm


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_feats_descs_cross_read_and_bytes(tmp_path):
    rng = np.random.default_rng(0)
    feats = rng.uniform(0, 500, (37, 4)).astype(np.float32)
    descs = rng.integers(0, 256, (37, 128)).astype(np.uint8)
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    jfio.save_feats(pj + ".feat", feats)
    tfio.save_feats(pt + ".feat", feats)
    jfio.save_descs(pj + ".desc", descs)
    tfio.save_descs(pt + ".desc", descs)
    assert _bytes(pj + ".feat") == _bytes(pt + ".feat")
    assert _bytes(pj + ".desc") == _bytes(pt + ".desc")
    np.testing.assert_array_equal(tfio.load_feats(pj + ".feat"), jfio.load_feats(pt + ".feat"))
    np.testing.assert_array_equal(tfio.load_descs(pj + ".desc"), descs)
    np.testing.assert_array_equal(jfio.load_descs(pt + ".desc"), descs)


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_matches_cross_read_and_bytes(tmp_path, ext):
    rng = np.random.default_rng(1)
    m = {(0, 1): rng.integers(0, 900, (50, 2)), (2, 5): rng.integers(0, 900, (3, 2)),
         (1, 4): np.zeros((0, 2), np.int64)}
    pj, pt = str(tmp_path / ("j" + ext)), str(tmp_path / ("t" + ext))
    jmio.save_matches(m, pj)
    tmio.save_matches(m, pt)
    assert _bytes(pj) == _bytes(pt)
    back = tmio.load_matches(pj)
    assert back.keys() == m.keys()
    for k in m:
        np.testing.assert_array_equal(back[k], m[k])


def _reference_scene():
    n = 3
    cams = jcm.Cameras(kind=np.array([3, 1], np.int32), width=np.array([640.0, 320.0]),
                       height=np.array([480.0, 240.0]),
                       params=np.array([[500.0, 320, 240, 0.1, -0.02, 0.003, 0, 0],
                                        [300.0, 160, 120, 0, 0, 0, 0, 0]]))
    sc = JScene(root_path="/data/images", view_filename=["a.png", "b.png", "c.jpg"],
                view_intrinsic=np.array([0, 0, 1], np.int32),
                view_pose=np.arange(n, dtype=np.int32),
                view_wh=np.array([[640, 480], [640, 480], [320, 240]], np.int32),
                cameras=cams)
    sc.pose_valid = np.array([True, False, True])
    sc.pose_R = np.tile(np.eye(3), (n, 1, 1))
    sc.pose_C = np.array([[0.0, 0, 0], [1, 2, 3], [0.5, -0.25, 1e-3]])
    sc.X = np.array([[0.1, 0.2, 3.0], [1.0, -1, 4]])
    sc.X_valid = np.array([True, True])
    sc.obs_landmark = np.array([1, 0, 0], np.int32)
    sc.obs_view = np.array([2, 0, 2], np.int32)
    sc.obs_x = np.array([[10.5, 20.25], [1, 2], [3, 4]])
    sc.obs_feat = np.array([7, 8, 9], np.int32)
    sc.obs_valid = np.ones(3, bool)
    sc.prior_center = np.zeros((n, 3))
    sc.prior_center_weight = np.zeros((n, 3))
    sc.prior_center[1] = [4000.0, 5000, 6000]
    sc.prior_center_weight[1] = [1.0, 1, 2]
    return sc


def test_sfm_data_json_cross_read_and_bytes(tmp_path):
    ref = _reference_scene()
    port = from_reference(ref)
    pj, pt = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jsfm.save_sfm_data(ref, pj)
    tsfm.save_sfm_data(port, pt)
    assert _bytes(pj) == _bytes(pt)
    # each package reads the other's file back to the same records
    back_t = tsfm.load_sfm_data(pj)
    back_j = jsfm.load_sfm_data(pt)
    pt2 = str(tmp_path / "t2.json")
    tsfm.save_sfm_data(from_reference(back_j), pt2)
    assert _bytes(pt2) == _bytes(pj)
    assert back_t.view_filename == ref.view_filename
    np.testing.assert_array_equal(back_t.cameras.params, ref.cameras.params)
    np.testing.assert_array_equal(back_t.pose_C[back_t.pose_valid],
                                  ref.pose_C[ref.pose_valid])


def test_sfm_data_other_formats_raise(tmp_path):
    """.bin and .xml are the reference's bytes and cross back; any other
    extension raises (tests/test_torch_formats.py holds the rest)."""
    ref = _reference_scene()
    port = from_reference(ref)
    for ext in (".bin", ".xml"):
        pj, pt = str(tmp_path / ("j" + ext)), str(tmp_path / ("t" + ext))
        jsfm.save_sfm_data(ref, pj)
        tsfm.save_sfm_data(port, pt)
        assert _bytes(pj) == _bytes(pt)
        back = tsfm.load_sfm_data(pj)
        np.testing.assert_array_equal(back.cameras.params, ref.cameras.params)
        np.testing.assert_array_equal(back.prior_center_weight, ref.prior_center_weight)
    for ext in (".ply", ".txt"):
        with pytest.raises(ValueError, match="extension"):
            tsfm.save_sfm_data(port, str(tmp_path / ("s" + ext)))
        with pytest.raises(ValueError, match="extension"):
            tsfm.load_sfm_data(str(tmp_path / ("s" + ext)))


@pytest.mark.parametrize("mode", ["gray", "rgb", "gray_float"])
def test_png_reader_equals_pil(tmp_path, mode):
    """Images written by the reference (PIL, adaptive row filters) read
    identically by the port's zlib reader and by PIL, as gray and RGB."""
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:61, 0:83]
    smooth = (127 + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0)).astype(np.uint8)
    if mode == "gray":
        img = smooth
    elif mode == "rgb":
        img = np.stack([smooth, rng.integers(0, 256, smooth.shape).astype(np.uint8),
                        255 - smooth], axis=-1)
    else:
        img = (smooth / 255.0).astype(np.float32)
    path = str(tmp_path / f"{mode}.png")
    jimage.write_image(path, img)
    for gray in (True, False):
        a = timage.read_image(path, grayscale=gray)
        b = jimage.read_image(path, grayscale=gray)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert timage.read_exif(path) == {"width": 83, "height": 61}


def test_png_writer_round_trip_through_pil(tmp_path):
    rng = np.random.default_rng(3)
    for shape in ((40, 31), (17, 9, 3)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        path = str(tmp_path / f"w{len(shape)}.png")
        timage.write_image(path, img)
        np.testing.assert_array_equal(timage.read_png(path), img)
        from PIL import Image

        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    assert os.path.getsize(path) > 0


def _png_with_filter(path, img, ftype):
    """Encode `img` as an 8-bit PNG whose rows all use one row filter
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth; PNG spec 9.2)."""
    import struct
    import zlib

    h = img.shape[0]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, -1).astype(np.int64)
    prior = np.zeros(rows.shape[1], np.int64)
    raw = b""
    for cur in rows:
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        p = left + prior - ul
        paeth = np.where((np.abs(p - left) <= np.abs(p - prior))
                         & (np.abs(p - left) <= np.abs(p - ul)), left,
                         np.where(np.abs(p - prior) <= np.abs(p - ul), prior, ul))
        pred = [0, left, prior, (left + prior) // 2, paeth][ftype]
        raw += bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prior = cur

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))

    ctype = {1: 0, 3: 2, 4: 6}[bpp]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], h, 8, ctype, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_reader_row_filters_equal_pil(tmp_path, ftype):
    """Each of the five row filters is undone as PIL undoes it, for gray,
    RGB and RGBA rows, and gray conversion matches PIL's "L"."""
    from PIL import Image

    rng = np.random.default_rng(10 + ftype)
    for shape in ((23, 19), (23, 19, 3), (23, 19, 4)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        path = str(tmp_path / f"f{ftype}_{len(shape)}_{shape[-1]}.png")
        _png_with_filter(path, img, ftype)
        with Image.open(path) as im:
            np.testing.assert_array_equal(timage.read_png(path), np.asarray(im))
        np.testing.assert_array_equal(timage.read_image(path, grayscale=True),
                                      jimage.read_image(path, grayscale=True))


def test_k_matrix_matches_reference():
    from openmvg_tpu.utils.hostmath import K_matrix_np as jK
    from openmvg_torch.models.cameras import K_matrix_np as tK

    params = np.random.default_rng(4).uniform(100, 900, (2, 3, 8))
    np.testing.assert_array_equal(tK(params), jK(params))
