"""Build-at-first-use for the port's native code.

The CUDA kernels (csrc/*.cu, nvcc for sm_90a) and the host libraries
(csrc/native.cpp, g++ with OpenMP; csrc/jpeg.cpp, the JPEG codec;
csrc/bench_native.cpp, the CPU baselines, with -march=native) are compiled
into the git-ignored openmvg_torch/_build/ the first time they are needed,
named by a hash of the source, every *.cuh header in csrc/, the other
sources it includes, the flags and, for -march=native, the target the
compiler resolves it to (build_tag), and loaded with ctypes.  A failed
build raises; nothing falls back.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]
CODEC_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
# as the reference's native/Makefile builds its baselines; kept out of
# native.cpp's flags, where FMA contraction would move the f64 polish's bits
BENCH_FLAGS = ["-O3", "-fopenmp", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built from "
                       "openmvg_torch/csrc/*.cu on a machine with the CUDA toolkit")


def gxx():
    cand = shutil.which("g++") or shutil.which("c++")
    if cand is None:
        raise RuntimeError("g++ not found: openmvg_torch/csrc/native.cpp needs a "
                           "C++ compiler with OpenMP")
    return cand


def _native_target(compiler):
    """What -march=native means on this machine, as the compiler resolves
    it, so that a build for one CPU never loads on another."""
    r = subprocess.run([compiler, "-march=native", "-Q", "--help=target"],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{compiler} -march=native -Q --help=target failed:\n{r.stderr}")
    return r.stdout


def build_tag(source, flags, csrc=CSRC, deps=(), compiler=None):
    """The name of a build: a hash of `source` (a file name under `csrc`),
    of every header there (*.cuh: a source may include any of them, and a
    header changed under a library of the old name would load a stale
    build), of the sources in `deps` that it includes, of the flags and,
    with -march=native, of the target `compiler` resolves it to."""
    h = hashlib.sha256()
    names = [source, *deps] + sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    for name in names:
        with open(os.path.join(csrc, name), "rb") as f:
            data = f.read()
        h.update(f"{name}\0{len(data)}\0".encode())
        h.update(data)
    h.update(" ".join(flags).encode())
    if "-march=native" in flags:
        h.update(_native_target(compiler or gxx()).encode())
    return h.hexdigest()[:12]


def build_shared(source, compiler, flags, deps=()):
    """Compile `source` (a file name under csrc/, which is on the include
    path; `deps` the other sources it includes) into a shared library in
    _build/ unless one of the same build_tag is there; returns
    (ctypes.CDLL, compiler log or "" when it was already built)."""
    path = os.path.join(CSRC, source)
    tag = build_tag(source, flags, deps=deps, compiler=compiler)
    stem = os.path.splitext(source)[0]
    so = os.path.join(BUILD_DIR, f"{stem}_{tag}.so")
    log = ""
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            r = subprocess.run([compiler, *flags, "-I", CSRC, "-o", tmp, path],
                               capture_output=True, text=True)
            log = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(f"{os.path.basename(compiler)} failed for "
                                   f"{path}:\n{log}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(so), log


_host = None


def host_library():
    """csrc/native.cpp (the f64 polish's LM step, the TBMR component tree)
    built with g++ and OpenMP once per source and flags version, loaded,
    and its entry points declared."""
    global _host
    if _host is None:
        lib, _ = build_shared("native.cpp", gxx(), GXX_FLAGS)
        p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        lib.omt_ba_lm_step_k.restype = i64
        lib.omt_ba_lm_step_k.argtypes = [
            p_i32, p_i32, p_f64, p_f64, p_f64, p_f64, p_f64, ctypes.c_int32,
            i64, i64, i64, ctypes.c_double, ctypes.c_int32, ctypes.c_double,
            ctypes.c_int32, p_f64]
        lib.omt_tbmr.restype = i64
        lib.omt_tbmr.argtypes = [p_u8, i64, i64, ctypes.c_int32, i64, ctypes.c_double, p_f64,
                                 i64]
        _host = lib
    return _host


_codec = None


def codec_library():
    """csrc/jpeg.cpp (the JPEG decoder and encoder) built with g++ once per
    source and flags version, loaded, and its entry points declared."""
    global _codec
    if _codec is None:
        lib, _ = build_shared("jpeg.cpp", gxx(), CODEC_FLAGS)
        i64 = ctypes.c_int64
        p_u8 = ctypes.POINTER(ctypes.c_uint8)
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
        _codec = lib
    return _codec


_bench = None


def bench_library():
    """csrc/bench_native.cpp (the CPU baselines, which include native.cpp's
    LM step) built with BENCH_FLAGS once per source and flags version,
    loaded, and its entry points declared."""
    global _bench
    if _bench is None:
        lib, _ = build_shared("bench_native.cpp", gxx(), BENCH_FLAGS, deps=("native.cpp",))
        p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        lib.omt_bench_match_2nn.restype = i64
        lib.omt_bench_match_2nn.argtypes = [p_u8, i64, p_u8, i64, i64, ctypes.c_double, p_i32,
                                            p_i32]
        lib.omt_bench_ba_lm_step.restype = i64
        lib.omt_bench_ba_lm_step.argtypes = [
            p_i32, p_i32, p_f64, p_f64, p_f64, p_f64, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, i64, i64, i64, ctypes.c_double, ctypes.c_int32, ctypes.c_double,
            p_f64]
        _bench = lib
    return _bench
