"""Build-at-first-use for the port's native code.

The CUDA kernels (csrc/*.cu, nvcc for sm_90a) and the host library
(csrc/native.cpp, g++ with OpenMP) are compiled into the git-ignored
openmvg_torch/_build/ the first time they are needed, named by a hash of
the source, every *.cuh header in csrc/ and the flags (build_tag), and loaded
with ctypes.  A failed build raises; nothing falls back.
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


def build_tag(source, flags, csrc=CSRC):
    """The name of a build: a hash of `source` (a file name under `csrc`),
    of every header there (*.cuh: a source may include any of them, and a
    header changed under a library of the old name would load a stale
    build) and of the flags."""
    h = hashlib.sha256()
    for name in [source] + sorted(f for f in os.listdir(csrc) if f.endswith(".cuh")):
        with open(os.path.join(csrc, name), "rb") as f:
            data = f.read()
        h.update(f"{name}\0{len(data)}\0".encode())
        h.update(data)
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:12]


def build_shared(source, compiler, flags):
    """Compile `source` (a file name under csrc/, which is on the include
    path) into a shared library in _build/ unless one of the same
    build_tag is there; returns (ctypes.CDLL, compiler log or "" when it
    was already built)."""
    path = os.path.join(CSRC, source)
    tag = build_tag(source, flags)
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
