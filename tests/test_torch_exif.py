"""The port's read_exif (openmvg_torch/io/exif.py, no PIL) against the
reference's (PIL's getexif()): equal on the tagged JPEGs of
test_torch_exif_init.py, on a PNG whose EXIF sits in an eXIf chunk, on a
JPEG whose FocalLength is in the Exif sub-IFD (which getexif() does not
merge, so neither package finds a focal), and on hand-built TIFF blocks in
both byte orders with unusual field types, a zero denominator (where
the reference's float() raises ZeroDivisionError, and the port's too), a
GPS IFD that runs past the block, a truncated IFD and a block that is not
TIFF.
PIL writes the images; without it the tests skip.
"""

import struct

import numpy as np
import pytest
from test_torch_exif_init import IMAGES, _write_jpegs

from openmvg_tpu.io import image as jimage
from openmvg_torch.io import image as timage


def _read(read_exif, path):
    """read_exif's dict, or the type of what it raised."""
    try:
        return read_exif(path)
    except Exception as e:  # the reference's own failure is part of its behaviour
        return type(e)


def _assert_like_reference(path):
    got, want = _read(timage.read_exif, path), _read(jimage.read_exif, path)
    assert got == want, (got, want)
    return got


def test_tagged_jpegs_read_like_the_reference(tmp_path):
    imgdir = str(tmp_path / "images")
    _write_jpegs(imgdir)
    for name, make, model, focal, gps in IMAGES:
        got = _assert_like_reference(f"{imgdir}/{name}")
        assert got.get("focal_mm") == focal and ("gps" in got) == (gps is not None)


def test_png_exif_chunk_reads_like_the_reference(tmp_path):
    """Fault 3.10: the focal of a PNG's eXIf chunk reaches init."""
    Image = pytest.importorskip("PIL.Image")
    ex = Image.Exif()
    ex[0x0110], ex[0x920A] = "NIKON D90", 35.0
    path = str(tmp_path / "n.png")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path, exif=ex)
    got = _assert_like_reference(path)
    assert got["model"] == "NIKON D90" and got["focal_mm"] == 35.0


def test_focal_in_the_exif_sub_ifd_goes_unseen(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    ex = Image.Exif()
    ex[0x010F] = "Canon"
    ex.get_ifd(0x8769)[0x920A] = 50.0
    path = str(tmp_path / "sub.jpg")
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(path, exif=ex)
    got = _assert_like_reference(path)
    assert got["make"] == "Canon" and "focal_mm" not in got


def _tiff(entries, endian="<", gps=None, ifd0_at=8):
    """A TIFF block: IFD0 of (tag, type, count, payload bytes) at ifd0_at,
    payloads over 4 bytes after it, and a GPS IFD (same form) after those
    with tag 0x8825 pointing at it."""
    def ifd(ents, at):
        n = len(ents)
        data_at = at + 2 + 12 * n + 4
        head, tail = struct.pack(endian + "H", n), b""
        for tag, typ, count, payload in ents:
            if len(payload) <= 4:
                head += struct.pack(endian + "HHL", tag, typ, count) + payload.ljust(4, b"\0")
            else:
                head += struct.pack(endian + "HHLL", tag, typ, count, data_at + len(tail))
                tail += payload
        return head + b"\0\0\0\0" + tail

    hdr = (b"II\x2a\x00" if endian == "<" else b"MM\x00\x2a") + struct.pack(endian + "L",
                                                                           ifd0_at)
    pad = b"\0" * (ifd0_at - 8)
    if gps is None:
        return hdr + pad + ifd(entries, ifd0_at)
    probe = ifd(entries + [(0x8825, 4, 1, b"\0" * 4)], ifd0_at)
    gps_at = ifd0_at + len(probe)
    body = ifd(entries + [(0x8825, 4, 1, struct.pack(endian + "L", gps_at))], ifd0_at)
    return hdr + pad + body + ifd(gps, gps_at)


def _rat(endian, *pairs):
    return b"".join(struct.pack(endian + "LL", a, b) for a, b in pairs)


def _with_app1(tmp_path, name, block):
    Image = pytest.importorskip("PIL.Image")
    path = str(tmp_path / name)
    Image.fromarray(np.full((9, 11, 3), 90, np.uint8)).save(path)
    with open(path, "rb") as f:
        data = f.read()
    app1 = b"Exif\x00\x00" + block
    with open(path, "wb") as f:
        f.write(data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:])
    return path


def _blocks():
    out = {}
    for e in ("<", ">"):
        gps = [(1, 2, 2, b"S\0"), (2, 5, 3, _rat(e, (33, 1), (51, 1), (2400, 100))),
               (3, 2, 2, b"W\0"), (4, 5, 3, _rat(e, (151, 1), (12, 1), (55, 1))),
               (6, 5, 1, _rat(e, (125, 10)))]
        out[f"full_{e}"] = _tiff([(271, 2, 6, b"NIKON\0"), (272, 2, 10, b"NIKON D90\0"),
                                  (37386, 5, 1, _rat(e, (35, 1)))], e, gps)
    e = "<"
    out["focal_short"] = _tiff([(272, 2, 10, b"NIKON D90\0"), (37386, 3, 1, b"\x23\x00")])
    out["focal_ascii"] = _tiff([(272, 2, 10, b"NIKON D90\0"), (37386, 2, 5, b"35.5\0")])
    out["focal_zero_denominator"] = _tiff([(272, 2, 5, b"X100\0"),
                                           (37386, 5, 1, _rat(e, (35, 0)))])
    out["focal_two_values"] = _tiff([(37386, 5, 2, _rat(e, (35, 1), (50, 1)))])
    out["model_bytes_two_nuls"] = _tiff([(272, 1, 6, b"D90\0\0 "), (271, 7, 3, b"ab\0")])
    out["unknown_type_only"] = _tiff([(272, 99, 4, b"abcd")])
    out["gps_past_the_end"] = _tiff([(272, 2, 4, b"D90\0"), (0x8825, 4, 1, b"\xff\xff\0\0")])
    out["gps_alt_two_values"] = _tiff([(272, 2, 4, b"D90\0")], e,
                                      [(2, 5, 3, _rat(e, (1, 1), (2, 1), (3, 1))),
                                       (4, 5, 3, _rat(e, (4, 1), (5, 1), (6, 1))),
                                       (6, 5, 2, _rat(e, (1, 1), (2, 1)))])
    full = _tiff([(271, 2, 6, b"Canon\0"), (272, 2, 20, b"Canon EOS 5D\0" + b"\0" * 7),
                  (37386, 5, 1, _rat(e, (50, 1)))])
    out["truncated_data"] = full[:-20]
    out["ifd0_offset_past_the_end"] = _tiff([(272, 2, 4, b"D90\0")], ifd0_at=8)[:4] + \
        struct.pack("<L", 4000)
    out["not_tiff"] = b"JUNKJUNKJUNK"
    out["empty"] = b""
    return out


@pytest.mark.parametrize("kind", sorted(_blocks()))
def test_tiff_blocks_read_like_the_reference(tmp_path, kind):
    _assert_like_reference(_with_app1(tmp_path, f"{kind}.jpg", _blocks()[kind]))
