"""Seeded mutations of JPEG files through the port's decoder
(openmvg_torch/csrc/jpeg.cpp): each must decode to an image or raise
ValueError or NotImplementedError.

    python tests/jpeg_mutations.py N [--seed S] [--asan DIR]

The files mutated are tests/torch_data's progressive and restart-marker
fixtures and the port's own baseline RGB and gray encodings of a seeded
image; each mutation overwrites 1-8 bytes (every other one within the
first 700 bytes, where the markers and tables lie), truncates, or
inserts or deletes 1-16 bytes.  Without --asan the process caps its
address space at 6 GiB, so a runaway allocation fails like a crash.
--asan builds jpeg.cpp with AddressSanitizer and UBSan into DIR and
decodes through that build; run it so:

    LD_PRELOAD="$(g++ -print-file-name=libasan.so) $(g++ -print-file-name=libubsan.so)" \\
    ASAN_OPTIONS=detect_leaks=0 UBSAN_OPTIONS=halt_on_error=1:print_stacktrace=1 \\
    python tests/jpeg_mutations.py 20000 --asan build/asan

Prints the counts of images, ValueErrors and NotImplementedErrors.
"""

import argparse
import ctypes
import os
import resource
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from openmvg_torch.io import jpeg  # noqa: E402
from openmvg_torch.utils import build  # noqa: E402


def asan_codec(out_dir):
    """jpeg.cpp built with -fsanitize=address,undefined and declared as
    build.codec_library declares the normal build."""
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libjpeg_asan.so")
    subprocess.run([build.gxx(), "-fsanitize=address,undefined", "-fno-omit-frame-pointer",
                    "-O1", "-g", "-shared", "-fPIC", "-std=c++17",
                    os.path.join(build.CSRC, "jpeg.cpp"), "-o", so], check=True)
    lib = ctypes.CDLL(so)
    i64, p_u8 = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
    lib.omt_jpeg_decode.restype = i64
    lib.omt_jpeg_decode.argtypes = [
        ctypes.c_char_p, i64, np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.POINTER(p_u8), ctypes.c_char_p, i64]
    lib.omt_jpeg_encode.restype = i64
    lib.omt_jpeg_encode.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"), i64, i64, ctypes.c_int32,
        ctypes.POINTER(p_u8)]
    lib.omt_jpeg_free.restype = None
    lib.omt_jpeg_free.argtypes = [ctypes.c_void_p]
    return lib


def mutate(b, rng, i):
    b = bytearray(b)
    kind = rng.integers(4)
    if kind == 0:
        for p in rng.integers(2, min(len(b), 700) if i % 2 else len(b), rng.integers(1, 9)):
            b[p] = rng.integers(256)
    elif kind == 1:
        b = b[:rng.integers(2, len(b))]
    elif kind == 2:
        p = rng.integers(2, len(b))
        b[p:p] = rng.integers(0, 256, rng.integers(1, 17)).astype(np.uint8).tobytes()
    else:
        p = rng.integers(2, len(b) - 1)
        del b[p:p + rng.integers(1, 17)]
    return bytes(b)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--asan", metavar="DIR")
    args = ap.parse_args()
    if args.asan:
        build._codec = asan_codec(args.asan)
    else:
        resource.setrlimit(resource.RLIMIT_AS, (6 << 30, 6 << 30))
    rng = np.random.default_rng(args.seed)
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    data = os.path.join(ROOT, "tests", "torch_data")
    seeds = [open(os.path.join(data, n), "rb").read() for n in ("progressive.jpg",
                                                               "restart.jpg")]
    seeds += [jpeg.encode_jpeg(img), jpeg.encode_jpeg(img[..., 0])]
    seen = {"image": 0, "ValueError": 0, "NotImplementedError": 0}
    for i in range(args.n):
        try:
            a = jpeg.decode_jpeg(mutate(seeds[i % len(seeds)], rng, i))
            assert a.dtype == np.uint8 and a.ndim in (2, 3), a.shape
            seen["image"] += 1
        except (ValueError, NotImplementedError) as e:
            seen[type(e).__name__] += 1
    print(seen["image"], seen["ValueError"], seen["NotImplementedError"])


if __name__ == "__main__":
    main()
