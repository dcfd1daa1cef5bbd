"""JPEG read and write without PIL (openmvg_torch/csrc/jpeg.cpp).

The reference reads and writes JPEG through PIL, which uses libjpeg-turbo
with its defaults; csrc/jpeg.cpp decodes and encodes as those defaults do,
so both packages see the same pixels and write the same files.  The marker
walk that gives a file's size and its EXIF block is here, in Python, and
needs no build.
"""

import ctypes
import struct

import numpy as np

_SOI = b"\xff\xd8\xff"
# SOFn markers that start a frame; C4 (DHT), C8 (JPG) and CC (DAC) do not
_SOF = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def is_jpeg(head: bytes) -> bool:
    return head[:3] == _SOI


def jpeg_segments(data: bytes):
    """(marker, payload) of every marker segment before the first SOS, as
    PIL's JPEG parser walks them."""
    if not is_jpeg(data):
        raise ValueError("not a JPEG file")
    pos = 2
    while pos < len(data):
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            return
        marker = data[pos]
        pos += 1
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9 or pos + 2 > len(data):
            return
        (length,) = struct.unpack_from(">H", data, pos)
        yield marker, data[pos + 2:pos + length]
        if marker == 0xDA:
            return
        pos += length


def jpeg_size_bytes(data: bytes):
    """(width, height) from the last SOF segment before the scan, as PIL
    reads it."""
    size = None
    for marker, body in jpeg_segments(data):
        if marker in _SOF and len(body) >= 5:
            h, w = struct.unpack_from(">HH", body, 1)
            size = (w, h)
    if size is None:
        raise ValueError("JPEG file without a SOF marker")
    return size


def jpeg_size(path):
    """(width, height) from the SOF marker, without decoding."""
    with open(path, "rb") as f:
        return jpeg_size_bytes(f.read())


def jpeg_exif_block(data: bytes):
    """The first APP1 payload that starts with Exif\\0\\0, as PIL keeps it
    in info["exif"], or None."""
    for marker, body in jpeg_segments(data):
        if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            return body
    return None


def decode_jpeg(data: bytes) -> np.ndarray:
    """The pixels of a JPEG file's bytes: (H, W) uint8 for one component,
    (H, W, 3) RGB uint8 for three.  Kinds the decoder does not read raise
    NotImplementedError naming them; a malformed file raises ValueError."""
    from openmvg_torch.utils.build import codec_library

    lib = codec_library()
    dims = np.zeros(3, np.int32)
    pix = ctypes.POINTER(ctypes.c_uint8)()
    err = ctypes.create_string_buffer(256)
    rc = lib.omt_jpeg_decode(data, len(data), dims, ctypes.byref(pix), err, len(err))
    if rc != 0:
        msg = err.value.decode("latin-1")
        raise (NotImplementedError if rc == -2 else ValueError)(f"JPEG: {msg}")
    w, h, c = (int(x) for x in dims)
    try:
        a = np.ctypeslib.as_array(pix, shape=(h * w * c,)).copy()
    finally:
        lib.omt_jpeg_free(pix)
    return a.reshape(h, w) if c == 1 else a.reshape(h, w, c)


def read_jpeg(path) -> np.ndarray:
    """(H, W) or (H, W, 3) uint8, the pixels PIL's decode gives."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read())


def encode_jpeg(a: np.ndarray) -> bytes:
    """(H, W) gray or (H, W, 3) RGB uint8 -> the bytes of PIL's default
    save of a .jpg (quality 75, 4:2:0, JFIF)."""
    from openmvg_torch.utils.build import codec_library

    a = np.ascontiguousarray(a, np.uint8)
    if a.ndim not in (2, 3) or (a.ndim == 3 and a.shape[2] != 3):
        raise ValueError(f"JPEG takes (H, W) gray or (H, W, 3) RGB, not {a.shape}")
    lib = codec_library()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.omt_jpeg_encode(a.reshape(-1), a.shape[1], a.shape[0], 1 if a.ndim == 2 else 3,
                            ctypes.byref(out))
    if n < 0:
        raise ValueError(f"JPEG cannot hold an image of {a.shape[1]} x {a.shape[0]}")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.omt_jpeg_free(out)


def write_jpeg(path, a: np.ndarray):
    with open(path, "wb") as f:
        f.write(encode_jpeg(a))
