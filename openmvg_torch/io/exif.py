"""EXIF without PIL: the TIFF structure inside a JPEG APP1 "Exif\\0\\0"
block or a PNG eXIf chunk, read as PIL's Image.getexif() reads it.

The reference's read_exif takes Make, Model and FocalLength from what
getexif() returns, which is IFD0 alone: the Exif sub-IFD (tag 0x8769),
where cameras put FocalLength, is not merged, so such a focal goes unseen
in both packages.  GPS comes from the GPS IFD (tag 0x8825), as
Exif.get_ifd reads it.  Values take the Python types PIL gives them
(TiffImagePlugin.ImageFileDirectory_v2): bytes for BYTE and UNDEFINED, str
for ASCII (one trailing NUL dropped, latin-1), int or float for the other
numbers, a rational that converts with float() (ZeroDivisionError over a
zero denominator, as IFDRational raises it, so that read_exif stops where
the reference's does), a tuple where a tag holds several values and its TIFF
definition does not ask for one.  An IFD whose entry or data runs past the
block keeps the entries read before it; a block without a TIFF header is
malformed (MalformedExif), as getexif() raises on it.
"""

import struct

# TIFF field type -> (struct code, bytes per value); codes None are raw bytes
_TYPES = {1: (None, 1), 2: (None, 1), 3: ("H", 2), 4: ("L", 4), 5: ("L", 8), 6: ("b", 1),
          7: (None, 1), 8: ("h", 2), 9: ("l", 4), 10: ("l", 8), 11: ("f", 4), 12: ("d", 8),
          13: ("L", 4), 16: ("Q", 8)}
# the TIFF definitions' value counts (PIL's TiffTags) of the tags read here;
# any other tag is taken as undefined (None)
_LENGTH_IFD0 = {271: 1, 272: 1, 0x8825: 1}  # Make, Model, GPSInfoIFD
_LENGTH_GPS = {1: 2, 2: 3, 3: 2, 4: 3, 6: 1}  # lat ref, lat, lon ref, lon, altitude
GPS_IFD = 0x8825
MAKE, MODEL, FOCAL_LENGTH = 271, 272, 37386


class MalformedExif(ValueError):
    """The block has no TIFF header that PIL accepts."""


class Rational:
    """A TIFF RATIONAL as PIL's IFDRational converts it."""

    def __init__(self, num, den):
        self.num, self.den = num, den

    def __float__(self):
        return self.num / self.den  # numbers.Rational.__float__

    def __repr__(self):
        return "nan" if self.den == 0 else str(float(self))


def _value(typ, data, endian, length):
    code, unit = _TYPES[typ]
    if typ == 2:
        values = [(data[:-1] if data.endswith(b"\0") else data).decode("latin-1", "replace")]
    elif code is None:
        values = [data]
    else:
        n = len(data) // struct.calcsize(endian + code)
        values = list(struct.unpack(f"{endian}{n}{code}", data))
        if typ in (5, 10):
            values = [Rational(a, b) for a, b in zip(values[::2], values[1::2])]
    if length == 1 or typ == 1 or len(values) == 1:
        return values[0]
    return tuple(values)


def _entries(buf, offset, endian):
    """{tag: (type, data)} of the IFD at `offset`, read as PIL reads one:
    unknown types and empty entries skipped, the last entry of a tag kept,
    and reading stopped (keeping what was read) at the first read past the
    end of the block."""
    out = {}
    if offset + 2 > len(buf):
        return out
    (count,) = struct.unpack_from(endian + "H", buf, offset)
    pos = offset + 2
    for _ in range(count):
        if pos + 12 > len(buf):
            break
        tag, typ, n, raw = struct.unpack_from(endian + "HHL4s", buf, pos)
        pos += 12
        if typ not in _TYPES:
            continue
        size = n * _TYPES[typ][1]
        if size > 4:
            (at,) = struct.unpack(endian + "L", raw)
            if at + size > len(buf):
                break
            data = buf[at:at + size]
        else:
            data = raw[:size]
        if data:
            out[tag] = (typ, data)
    return out


def parse_exif(block: bytes):
    """IFD0's tags and the GPS IFD of an EXIF block (leading Exif\\0\\0
    headers dropped): ({tag: value} of Make, Model and FocalLength,
    number of IFD0 tags, {tag: value} of the GPS IFD or None when it cannot
    be read)."""
    while block.startswith(b"Exif\x00\x00"):
        block = block[6:]
    if not block:
        return {}, 0, None
    head = block[:8]
    if head[:4] in (b"II\x2a\x00", b"II\x00\x2a"):
        endian = "<"
    elif head[:4] in (b"MM\x00\x2a", b"MM\x2a\x00"):
        endian = ">"
    else:
        raise MalformedExif(f"not a TIFF header: {head[:4]!r}")
    if len(head) < 8:
        raise MalformedExif("truncated TIFF header")
    (ifd0,) = struct.unpack_from(endian + "L", head, 4)
    entries = _entries(block, ifd0, endian)
    tags = {t: _value(typ, data, endian, _LENGTH_IFD0.get(t))
            for t, (typ, data) in entries.items() if t in (MAKE, MODEL, FOCAL_LENGTH, GPS_IFD)}
    gps = None
    offset = tags.get(GPS_IFD)
    if type(offset) is int and offset >= 0:
        gps = {t: _value(typ, data, endian, _LENGTH_GPS.get(t))
               for t, (typ, data) in _entries(block, offset, endian).items()}
    return tags, len(entries), gps
