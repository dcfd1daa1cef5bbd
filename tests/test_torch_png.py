"""The port's PNG reader against the reference's PIL reader: read_image,
gray and RGB, equal exactly on every colour type and bit depth PNG has,
with and without Adam7 interlacing, and on palettes with and without
tRNS.  PIL writes the kinds it can write; the rest (2- and 4-bit gray,
16-bit RGB(A) and gray+alpha, interlaced files, an index past the
palette) are written here and read by PIL as the yardstick.  Without PIL
the tests skip.
"""

import struct
import zlib

import numpy as np
import pytest

from openmvg_tpu.io import image as jimage
from openmvg_torch.io import image as timage

H, W = 13, 21  # odd sizes: partial bytes of packed rows, short Adam7 passes
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _chunk(t, body):
    return struct.pack(">I", len(body)) + t + body + struct.pack(
        ">I", zlib.crc32(t + body) & 0xFFFFFFFF)


def _filter_rows(rows, bpp, start):
    """Filter each row with types start, start + 1, ... (mod 5), PNG spec 9.2."""
    out = b""
    prior = np.zeros(rows.shape[1], np.int64)
    for r, cur in enumerate(rows.astype(np.int64)):
        ftype = (start + r) % 5
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        p = left + prior - ul
        paeth = np.where((np.abs(p - left) <= np.abs(p - prior))
                         & (np.abs(p - left) <= np.abs(p - ul)), left,
                         np.where(np.abs(p - prior) <= np.abs(p - ul), prior, ul))
        pred = [0, left, prior, (left + prior) // 2, paeth][ftype]
        out += bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prior = cur
    return out


def _pack(samples, depth):
    """(h, w, ch) levels -> (h, stride) bytes of one pass."""
    h, w, ch = samples.shape
    flat = samples.reshape(h, w * ch).astype(np.uint32)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(h, -1), axis=1)


def _png(samples, depth, ctype, interlace=False, plte=None, trns=None):
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for i, (x0, y0, dx, dy) in enumerate(passes):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(_pack(sub, depth), bpp, i)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _levels(rng, depth, ch, hi=None):
    return rng.integers(0, hi or (1 << depth), (H, W, ch)).astype(np.uint16)


def _palette(rng, n):
    return rng.integers(0, 256, (n, 3)).astype(np.uint8).tobytes()


def _hand(kind, interlace, rng):
    """PNG bytes of the kinds PIL cannot write."""
    if kind in ("gray1", "gray2", "gray4", "gray8", "gray16"):
        d = int(kind[4:])
        return _png(_levels(rng, d, 1), d, 0, interlace)
    if kind in ("rgb8", "rgb16", "rgba8", "rgba16", "la8", "la16"):
        d = int(kind.lstrip("rgbla"))
        ch, ct = {"rgb": (3, 2), "rgba": (4, 6), "la": (2, 4)}[kind.rstrip("0123456789")]
        return _png(_levels(rng, d, ch), d, ct, interlace)
    if kind in ("palette1", "palette2", "palette4", "palette8"):
        d = int(kind[7:])
        return _png(_levels(rng, d, 1), d, 3, interlace, plte=_palette(rng, 1 << d))
    if kind == "palette_short":  # indices past the 5 PLTE entries read black
        return _png(_levels(rng, 8, 1, 9), 8, 3, interlace, plte=_palette(rng, 5))
    if kind == "palette_trns":
        return _png(_levels(rng, 4, 1), 4, 3, interlace, plte=_palette(rng, 16),
                    trns=bytes(range(0, 160, 10)))
    raise KeyError(kind)


def _pil_written(kind, rng, path):
    Image = pytest.importorskip("PIL.Image")
    if kind == "pil_palette":
        im = Image.fromarray(rng.integers(0, 256, (H, W, 3)).astype(np.uint8)).quantize(37)
        im.save(path)
    elif kind == "pil_palette_trns":
        im = Image.fromarray(rng.integers(0, 256, (H, W, 3)).astype(np.uint8)).quantize(37)
        im.save(path, transparency=3)
    elif kind in ("pil_palette1", "pil_palette2", "pil_palette4"):
        bits = int(kind[-1])
        im = Image.fromarray(rng.integers(0, 256, (H, W, 3)).astype(np.uint8)).quantize(1 << bits)
        im.save(path, bits=bits)
    elif kind == "pil_gray1":
        Image.fromarray(rng.integers(0, 2, (H, W)).astype(bool)).save(path)
    elif kind == "pil_gray16":
        Image.fromarray(rng.integers(0, 65536, (H, W)).astype(np.uint16)).save(path)
    elif kind == "pil_la":
        Image.fromarray(rng.integers(0, 256, (H, W, 2)).astype(np.uint8), "LA").save(path)
    elif kind == "pil_rgba":
        Image.fromarray(rng.integers(0, 256, (H, W, 4)).astype(np.uint8), "RGBA").save(path)
    else:
        raise KeyError(kind)


def _assert_read_like_reference(path):
    for gray in (True, False):
        a = timage.read_image(path, grayscale=gray)
        b = jimage.read_image(path, grayscale=gray)
        assert a.dtype == b.dtype and a.shape == b.shape, (gray, a.shape, b.shape)
        np.testing.assert_array_equal(a, b)


PIL_KINDS = ["pil_palette", "pil_palette_trns", "pil_palette1", "pil_palette2",
             "pil_palette4", "pil_gray1", "pil_gray16", "pil_la", "pil_rgba"]
HAND_KINDS = ["gray1", "gray2", "gray4", "gray8", "gray16", "rgb8", "rgb16", "rgba8",
              "rgba16", "la8", "la16", "palette1", "palette2", "palette4", "palette8",
              "palette_short", "palette_trns"]


@pytest.mark.parametrize("kind", PIL_KINDS)
def test_pil_written_png_reads_like_the_reference(tmp_path, kind):
    path = str(tmp_path / f"{kind}.png")
    _pil_written(kind, np.random.default_rng(len(kind)), path)
    _assert_read_like_reference(path)


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("kind", HAND_KINDS)
def test_every_png_kind_reads_like_the_reference(tmp_path, kind, interlace):
    pytest.importorskip("PIL.Image")
    path = str(tmp_path / f"{kind}.png")
    with open(path, "wb") as f:
        f.write(_hand(kind, interlace, np.random.default_rng(len(kind) + 7 * interlace)))
    _assert_read_like_reference(path)


def test_read_png_gives_the_stored_samples(tmp_path):
    """read_png keeps the file's levels: 16-bit samples as uint16, palette
    indices and low-depth levels unscaled."""
    rng = np.random.default_rng(5)
    for depth, ct, ch in ((16, 2, 3), (4, 0, 1), (2, 3, 1)):
        lev = _levels(rng, depth, ch)
        path = str(tmp_path / f"s{depth}_{ct}.png")
        plte = _palette(rng, 1 << depth) if ct == 3 else None
        with open(path, "wb") as f:
            f.write(_png(lev, depth, ct, True, plte=plte))
        got = timage.read_png(path)
        assert got.dtype == (np.uint16 if depth == 16 else np.uint8)
        np.testing.assert_array_equal(got, lev[..., 0] if ch == 1 else lev)


def test_invalid_png_kind_raises(tmp_path):
    """A bit depth the colour type does not allow is a malformed file."""
    path = str(tmp_path / "bad.png")
    with open(path, "wb") as f:
        f.write(_png(np.zeros((H, W, 3), np.uint16), 4, 2))
    with pytest.raises(ValueError, match="not valid"):
        timage.read_image(path)
