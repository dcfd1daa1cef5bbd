"""The port's JPEG codec (openmvg_torch/csrc/jpeg.cpp through
openmvg_torch/io/jpeg.py) against PIL, which the reference reads and
writes JPEG with:
- read_image, gray and RGB, equals the reference's exactly on odd-sized
  gray, 4:4:4, 4:2:2, 4:2:0, progressive, restart-marker, optimised-table
  and 4:4:0 files;
- the port's default save is the file PIL writes for the same array, and
  PIL decodes it to the pixels of its own save;
- the committed fixtures of tests/torch_data (a progressive and a
  restart-marker file written by PIL) and the port's encoding of their
  pixels decode to the sha256 digests in jpeg_digests.json, under PIL and
  under the port: chip_smoke.py holds the card machine's build, which has
  no PIL, to the same digests;
- the kinds the decoder does not read raise NotImplementedError naming
  them;
- PNG and JPEG reading, writing and EXIF never import PIL;
- seeded mutations of JPEG files decode or raise, and never crash the
  process.
PIL writes the files; without it the tests that need it skip.
"""

import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from openmvg_tpu.io import image as jimage
from openmvg_torch.io import image as timage
from openmvg_torch.io import jpeg as tjpeg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "torch_data")
H, W = 37, 53  # odd: partial MCUs, an odd chroma column and row


def _image(ch, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    a = (128 + 60 * np.sin(xx / 5.0) + 50 * np.cos(yy / 3.0))[..., None] + rng.normal(
        0, 30, (H, W, ch))
    a[H // 3:H // 2, W // 4:W // 2] = 250  # hard edges: IDCT overshoot, clamps
    a[H // 2:, :W // 5] = 2
    a = np.clip(a, 0, 255).astype(np.uint8)
    return a[..., 0] if ch == 1 else a


def _pil_jpeg(a, **kw):
    Image = pytest.importorskip("PIL.Image")
    b = io.BytesIO()
    Image.fromarray(a).save(b, format="JPEG", **kw)
    return b.getvalue()


def _as_440(data, w, h):
    """A 4:2:2 file (Y 2x1, MCU 16 x 8) relabelled as 4:4:0 (Y 1x2, MCU
    8 x 16) of w x h: the same blocks in the same order, so libjpeg decodes
    it as a valid 4:4:0 image when the MCU grids hold as many MCUs."""
    d = bytearray(data)
    i = d.index(b"\xff\xc0")
    assert d[i + 11] == 0x21
    d[i + 5:i + 7] = h.to_bytes(2, "big")
    d[i + 7:i + 9] = w.to_bytes(2, "big")
    d[i + 11] = 0x12
    return bytes(d)


KINDS = {
    "gray": lambda: _pil_jpeg(_image(1, 0)),
    "444": lambda: _pil_jpeg(_image(3, 1), subsampling=0),
    "422": lambda: _pil_jpeg(_image(3, 2), subsampling=1),
    "420": lambda: _pil_jpeg(_image(3, 3), subsampling=2),
    "progressive": lambda: _pil_jpeg(_image(3, 4), progressive=True),
    "progressive_gray": lambda: _pil_jpeg(_image(1, 5), progressive=True, quality=95),
    "restart_marker_blocks": lambda: _pil_jpeg(_image(3, 6), restart_marker_blocks=3),
    "restart_marker_rows": lambda: _pil_jpeg(_image(3, 7), restart_marker_rows=1,
                                             subsampling=0),
    "optimize_q10": lambda: _pil_jpeg(_image(3, 8), optimize=True, quality=10),
    # 64 x 40 at 4:2:2 is 4 x 5 MCUs; 29 x 75 at 4:4:0 is 4 x 5 too
    "440": lambda: _as_440(_pil_jpeg(np.ascontiguousarray(np.resize(_image(3, 9), (40, 64, 3))),
                                     subsampling=1), 29, 75),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decode_equals_pil(tmp_path, kind):
    Image = pytest.importorskip("PIL.Image")
    data = KINDS[kind]()
    path = str(tmp_path / f"{kind}.jpg")
    with open(path, "wb") as f:
        f.write(data)
    with Image.open(path) as im:
        np.testing.assert_array_equal(tjpeg.read_jpeg(path), np.asarray(im))
    for gray in (True, False):
        a = timage.read_image(path, grayscale=gray)
        b = jimage.read_image(path, grayscale=gray)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert timage.read_exif(path) == jimage.read_exif(path)


@pytest.mark.parametrize("ch", [1, 3], ids=["gray", "rgb"])
def test_default_save_is_pils(tmp_path, ch):
    """write_image(.jpg) writes PIL's default save byte for byte, and PIL
    decodes it to exactly the pixels of its own save."""
    Image = pytest.importorskip("PIL.Image")
    for seed, (h, w) in enumerate(((H, W), (16, 32), (1, 1), (9, 250))):
        a = np.resize(_image(ch, 10 + seed), (h, w) if ch == 1 else (h, w, ch))
        path = str(tmp_path / f"t{seed}.jpg")
        timage.write_image(path, a)
        ref = _pil_jpeg(a)
        with open(path, "rb") as f:
            assert f.read() == ref
        with Image.open(path) as got, Image.open(io.BytesIO(ref)) as want:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        jpath = str(tmp_path / f"j{seed}.jpg")
        jimage.write_image(jpath, a)
        np.testing.assert_array_equal(timage.read_image(path), jimage.read_image(jpath))


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_golden_digests():
    """The fixtures and the port's encoding of their pixels decode to the
    committed digests, under PIL and under the port."""
    Image = pytest.importorskip("PIL.Image")
    with open(os.path.join(DATA, "jpeg_digests.json")) as f:
        want = json.load(f)
    for name in ("progressive.jpg", "restart.jpg"):
        path = os.path.join(DATA, name)
        with Image.open(path) as im:
            assert _sha(np.asarray(im.convert("RGB"))) == want[name]
        assert _sha(tjpeg.read_jpeg(path)) == want[name]
    rgb = tjpeg.read_jpeg(os.path.join(DATA, "progressive.jpg"))
    for name, a in (("encode_rgb", rgb), ("encode_gray", timage.rgb_to_gray_u8(rgb))):
        data = tjpeg.encode_jpeg(a)
        with Image.open(io.BytesIO(data)) as im:
            assert _sha(np.asarray(im)) == want[name]
        assert _sha(tjpeg.decode_jpeg(data)) == want[name]


def _patched(data, at, value):
    d = bytearray(data)
    d[at] = value
    return bytes(d)


def test_unsupported_kinds_raise_naming_them(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    base = _pil_jpeg(_image(3, 20))
    sof = base.index(b"\xff\xc0")
    cases = {
        "arithmetic coding": _patched(base, sof + 1, 0xC9),
        "lossless": _patched(base, sof + 1, 0xC3),
        "12-bit": _patched(base, sof + 4, 12),
    }
    b = io.BytesIO()
    Image.fromarray(_image(3, 21)).convert("CMYK").save(b, format="JPEG")
    cases["CMYK"] = b.getvalue()
    for what, data in cases.items():
        with pytest.raises(NotImplementedError, match=what):
            tjpeg.decode_jpeg(data)
    with pytest.raises(ValueError, match="not a JPEG"):
        tjpeg.decode_jpeg(b"\x89PNG")


def test_size_without_decoding(tmp_path):
    path = str(tmp_path / "s.jpg")
    with open(path, "wb") as f:
        f.write(KINDS["progressive"]())
    assert tjpeg.jpeg_size(path) == (W, H)


def test_png_and_jpeg_paths_never_import_pil(tmp_path):
    """With PIL blocked, PNG and JPEG are written, read (gray and RGB) and
    their EXIF read; TIFF names PIL in its error."""
    code = f"""
import sys
sys.modules["PIL"] = None
import numpy as np
from openmvg_torch.io import image
a = np.arange(3 * 17 * 29, dtype=np.int64).reshape(17, 29, 3).astype(np.uint8)
for ext in ("png", "jpg"):
    p = {str(tmp_path)!r} + "/x." + ext
    image.write_image(p, a)
    assert image.read_image(p).shape == (17, 29, 3)
    assert image.read_image(p, grayscale=True).shape == (17, 29)
    assert image.read_exif(p) == {{"width": 29, "height": 17}}
try:
    image.read_image({str(tmp_path)!r} + "/x.tif")
except ImportError as e:
    assert "needs PIL" in str(e), e
    print("ok")
"""
    open(tmp_path / "x.tif", "wb").write(b"II*\x00")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_mutated_files_raise_or_decode_in_a_subprocess():
    """800 seeded mutations of JPEG files (tests/jpeg_mutations.py: bytes
    overwritten, many among the markers and tables; truncation; bytes
    inserted or deleted): each decodes to an image or raises ValueError or
    NotImplementedError.  The decoder runs in a child process with its
    address space capped at 6 GiB, so a crash, a hang or a runaway
    allocation fails the test instead of the test run."""
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "jpeg_mutations.py"), "800"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.returncode, r.stderr[-2000:])
    n_image, n_value, n_unsupported = map(int, r.stdout.split())
    assert n_image + n_value + n_unsupported == 800
    assert n_image > 0 and n_value > 0  # both outcomes exercised


def test_dc_table_value_above_15_raises():
    """A DC Huffman table's values are bit counts: one above 15 is refused
    when a scan uses the table, as libjpeg's jdhuff.c refuses it, instead
    of shifting by more than the bit buffer holds."""
    data = bytearray(tjpeg.encode_jpeg(_image(1, 3)))
    at = data.index(b"\xff\xc4")  # the first DHT: the DC table 0
    assert data[at + 4] == 0x00
    data[at + 5 + 16] = 0x20
    with pytest.raises(ValueError, match="bad Huffman table"):
        tjpeg.decode_jpeg(bytes(data))
