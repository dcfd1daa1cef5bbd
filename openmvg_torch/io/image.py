"""Host-side image IO + EXIF (counterpart: openmvg_tpu/io/image.py).

The reference reads and writes every format through PIL.  The machines
the port runs on need not have PIL, so PNG and JPEG never touch it here,
even where it is installed:
- PNG is read here with zlib and struct: colour types 0, 2, 3 (through
  PLTE; tRNS dropped, as convert("RGB") drops it), 4 and 6, bit depths 1,
  2, 4, 8 and 16, the five row filters and Adam7 interlacing; and written
  as 8-bit gray or RGB with the Up filter;
- JPEG goes through io/jpeg.py (csrc/jpeg.cpp, libjpeg-turbo's default
  decode and PIL's default encode);
- EXIF of a JPEG APP1 block or a PNG eXIf chunk goes through io/exif.py,
  with PIL's getexif() semantics.
read_image applies PIL's "L" and "RGB" conversions of each PNG mode, as
Pillow 12.1 does them: 1-bit gray to 0/255, 2-bit x 85, 4-bit x 17,
16-bit gray clipped at 255 (not scaled), 16-bit RGB(A) and gray+alpha by
their high byte, palette entries past PLTE black, alpha dropped, and RGB
-> gray by PIL's "L" rounding, (19595 R + 38470 G + 7471 B + 0x8000) >> 16
(Rec.601 weights, image_converter.hpp Rgb2Gray).  TIFF and the other
formats still go through PIL, imported only for them.
"""

import os
import struct
import zlib
from typing import Optional

import numpy as np

from openmvg_torch.io import exif as _exif
from openmvg_torch.io import jpeg as _jpeg

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _head(path, n=8):
    with open(path, "rb") as f:
        return f.read(n)


def _png_chunks(data):
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        ctype = data[pos + 4:pos + 8]
        yield ctype, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IEND":
            return


def png_size(path):
    """(width, height) from the IHDR chunk."""
    head = _head(path, 24)
    if head[:8] != _PNG_SIG or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack_from(">II", head, 16)


def _unfilter_slow(ftype, raw, prior, bpp):
    """Average (3) and Paeth (4) rows: each byte depends on its reconstructed
    left neighbour, so they are undone byte by byte."""
    out = bytearray(raw)
    n = len(out)
    for i in range(n):
        left = out[i - bpp] if i >= bpp else 0
        up = prior[i]
        if ftype == 3:
            out[i] = (out[i] + ((left + up) >> 1)) & 0xFF
        else:
            ul = prior[i - bpp] if i >= bpp else 0
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = left if (pa <= pb and pa <= pc) else (up if pb <= pc else ul)
            out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(raw, h, stride, bpp, path):
    """(h, stride + 1) filtered rows -> (h, stride) bytes."""
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(h):
        ftype, line = int(raw[r, 0]), raw[r, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum per byte of a pixel, mod 256
            pad = (-stride) % bpp
            cur = np.cumsum(np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp),
                            axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):
            cur = _unfilter_slow(ftype, line.tobytes(), prior.tobytes(), bpp)
        else:
            raise ValueError(f"{path}: bad PNG filter type {ftype}")
        out[r] = cur
        prior = out[r]
    return out


def _unpack(rows, w, ch, depth):
    """(h, stride) unfiltered bytes -> (h, w, ch) samples: uint8 for depths
    up to 8 (unscaled levels), uint16 for 16."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2")[:, :w * ch].astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return rows[:, :w * ch].reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1)[:, :w * ch * depth].reshape(h, w * ch, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8).reshape(h, w, ch)


def _decode_png(data, path):
    """A PNG file's bytes -> (samples (H, W, C), colour type, bit depth,
    palette (256, 3) uint8 or None)."""
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    idat, hdr, plte = [], None, None
    for ctype, body in _png_chunks(data):
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body[:13])
        elif ctype == b"PLTE":
            plte = body
        elif ctype == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _DEPTHS or depth not in _DEPTHS[ctype] or interlace not in (0, 1):
        raise ValueError(f"{path}: PNG colour type {ctype}, bit depth {depth}, interlace "
                         f"{interlace} is not valid")
    ch = _CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    samples = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * ch * depth + 7) // 8
        block = raw[pos:pos + ph * (stride + 1)]
        if block.size < ph * (stride + 1):
            raise ValueError(f"{path}: truncated PNG image data")
        pos += ph * (stride + 1)
        rows = _unfilter(block.reshape(ph, stride + 1), ph, stride, bpp, path)
        samples[y0::dy, x0::dx] = _unpack(rows, pw, ch, depth)
    palette = None
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        palette = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte[:len(plte) // 3 * 3], np.uint8).reshape(-1, 3)[:256]
        palette[:len(entries)] = entries
    return samples, ctype, depth, palette


def read_png(path) -> np.ndarray:
    """PNG -> its samples as stored: (H, W) or (H, W, C) uint8 for bit
    depths up to 8 (gray levels and palette indices unscaled), uint16 for
    16; alpha kept.  read_image gives PIL's "L" and "RGB" readings."""
    with open(path, "rb") as f:
        samples = _decode_png(f.read(), path)[0]
    return samples[..., 0] if samples.shape[2] == 1 else samples


def _png_pil(samples, ctype, depth, palette, grayscale):
    """PIL's convert("L") / convert("RGB") of the mode Pillow opens the PNG
    in (PngImagePlugin._MODES)."""
    if ctype == 3:
        rgb = palette[samples[..., 0]]
        return rgb_to_gray_u8(rgb) if grayscale else rgb
    if depth == 16:
        if ctype == 0:  # "I;16": clipped at 255
            g = np.minimum(samples[..., 0], 255).astype(np.uint8)
        else:  # "RGB;16B", "RGBA;16B", "LA;16B" -> the high byte
            samples = (samples >> 8).astype(np.uint8)
    elif ctype == 0:  # "1", "L;2", "L;4", "L"
        g = samples[..., 0] * np.uint8({1: 255, 2: 85, 4: 17, 8: 1}[depth])
    if ctype in (0, 4):
        g = g if ctype == 0 else samples[..., 0]
        return g if grayscale else np.repeat(g[..., None], 3, axis=2)
    rgb = samples[..., :3]
    return rgb_to_gray_u8(rgb) if grayscale else np.ascontiguousarray(rgb)


def _png_chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_png(path, a: np.ndarray):
    """(H, W) gray or (H, W, 3) RGB uint8 -> PNG with the Up row filter."""
    a = np.ascontiguousarray(a, np.uint8)
    h, w = a.shape[:2]
    ctype = {2: 0, 3: 2}[a.ndim]
    rows = a.reshape(h, -1)
    up = rows.copy()
    up[1:] -= rows[:-1]  # uint8 wraps mod 256, as the filter defines
    filtered = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                                0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def rgb_to_gray_u8(rgb):
    """PIL "L" conversion of (..., 3) uint8 RGB."""
    c = np.asarray(rgb, np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _pil(path, what):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: {what} of a file that is neither PNG nor JPEG (TIFF, "
                          "BMP, ...) needs PIL, which is not installed") from e
    return Image


def read_image(path, grayscale=False):
    """grayscale: (H, W) float32 in [0, 1]; else (H, W, 3) uint8 RGB."""
    head = _head(path)
    if head == _PNG_SIG:
        with open(path, "rb") as f:
            samples, ctype, depth, palette = _decode_png(f.read(), path)
        a = _png_pil(samples, ctype, depth, palette, grayscale)
    elif _jpeg.is_jpeg(head):
        a = _jpeg.read_jpeg(path)
        if grayscale and a.ndim == 3:
            a = rgb_to_gray_u8(a)
        elif not grayscale and a.ndim == 2:
            a = np.repeat(a[..., None], 3, axis=2)
    else:
        im = _pil(path, "reading").open(path)
        a = np.asarray(im.convert("L" if grayscale else "RGB"), np.uint8)
    return a.astype(np.float32) / 255.0 if grayscale else a


def write_image(path, array):
    """Float arrays in [0, 1] are scaled by 255 and truncated, as the
    reference writer does.  PNG and JPEG are written here (JPEG as the
    bytes of PIL's default save); other formats via PIL."""
    a = np.asarray(array)
    if a.dtype != np.uint8:
        a = np.clip(a * 255.0, 0, 255).astype(np.uint8)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        write_png(path, a)
    elif ext in (".jpg", ".jpeg"):
        _jpeg.write_jpeg(path, a)
    else:
        _pil(path, "writing").fromarray(a).save(path)


def read_exif(path) -> dict:
    """{width, height} and, where the file has an EXIF block with tags,
    {model, make, focal_mm, gps} (keys best-effort), as the reference
    builds them from PIL's getexif()."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIG:
        w, h = png_size(path)
        chunks = [body for ctype, body in _png_chunks(data) if ctype == b"eXIf"]
        block = b"Exif\x00\x00" + chunks[-1] if chunks else None  # the last, as PIL keeps it
    elif _jpeg.is_jpeg(data):
        w, h = _jpeg.jpeg_size_bytes(data)
        block = _jpeg.jpeg_exif_block(data)
    else:
        return _read_exif_pil(path)
    out = {"width": w, "height": h}
    if block is None:
        return out
    try:
        tags, n_tags, gps = _exif.parse_exif(block)
    except _exif.MalformedExif:  # keep the size only, as the reference does
        return out
    if not n_tags:
        return out
    out["model"] = str(tags.get(_exif.MODEL, "")).strip()
    out["make"] = str(tags.get(_exif.MAKE, "")).strip()
    focal = tags.get(_exif.FOCAL_LENGTH)
    if focal is not None:
        try:
            out["focal_mm"] = float(focal)
        except (TypeError, ValueError):
            pass
    if gps:
        out["gps"] = _parse_gps(gps)
    return out


def _read_exif_pil(path):
    Image = _pil(path, "EXIF")
    from PIL import ExifTags

    out = {}
    with Image.open(path) as im:
        out["width"], out["height"] = im.size
        try:
            exif = im.getexif()
        except Exception:  # malformed EXIF block: keep the size only
            return out
        if not exif:
            return out
        tags = {ExifTags.TAGS.get(k, k): v for k, v in exif.items()}
        out["model"] = str(tags.get("Model", "")).strip()
        out["make"] = str(tags.get("Make", "")).strip()
        focal = tags.get("FocalLength")
        if focal is not None:
            try:
                out["focal_mm"] = float(focal)
            except (TypeError, ValueError):
                pass
        try:
            gps_ifd = exif.get_ifd(ExifTags.IFD.GPSInfo)
            if gps_ifd:
                out["gps"] = _parse_gps(gps_ifd)
        except Exception:  # malformed GPS IFD: no GPS prior
            pass
    return out


def _parse_gps(ifd):
    def dms(v, ref, neg):
        d = float(v[0]) + float(v[1]) / 60.0 + float(v[2]) / 3600.0
        return -d if ref in neg else d

    try:
        lat = dms(ifd[2], str(ifd.get(1, "N")), ("S",))
        lon = dms(ifd[4], str(ifd.get(3, "E")), ("W",))
        return dict(lat=lat, lon=lon, alt=float(ifd.get(6, 0.0)))
    except (KeyError, IndexError, TypeError, ValueError, ZeroDivisionError):
        return None


_BUILTIN_SENSOR_DB = {
    "canon eos 5d mark ii": 36.0,
    "canon eos 5d": 35.8,
    "canon eos 1100d": 22.2,
    "nikon d90": 23.6,
    "nikon d3200": 23.2,
    "sony ilce-7m3": 35.6,
    "iphone 12": 5.78,
    "iphone 13": 7.01,
    "dji fc330": 6.24,
    "kodak z612": 5.75,
}


def load_sensor_database(path: Optional[str] = None) -> dict:
    """Built-in sensor widths (mm) plus an openMVG "Model;width" file."""
    db = dict(_BUILTIN_SENSOR_DB)
    if path and os.path.exists(path):
        with open(path, errors="ignore") as f:
            for line in f:
                parts = line.strip().split(";")
                if len(parts) >= 2:
                    try:
                        db[parts[0].strip().lower()] = float(parts[1])
                    except ValueError:
                        continue
    return db


def focal_from_exif(exif: dict, db: dict) -> Optional[float]:
    """focal_pixels = max(w, h) * focal_mm / sensor_width_mm
    (main_SfMInit_ImageListing.cpp)."""
    model = str(exif.get("model", "")).lower()
    focal_mm = exif.get("focal_mm")
    if not model or not focal_mm:
        return None
    width_mm = db.get(model)
    if width_mm is None:
        width_mm = db.get((str(exif.get("make", "")).lower() + " " + model).strip())
    if width_mm is None:
        return None
    return max(exif["width"], exif["height"]) * focal_mm / width_mm
