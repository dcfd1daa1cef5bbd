"""Kernel K1: fused exact squared-L2 2-NN matching, and its plain version.

Counterpart: openmvg_tpu/ops/pallas_matching.py::two_nn_fused (the Pallas
TPU kernel).  The CUDA source is openmvg_torch/csrc/two_nn.cu; it is built
with nvcc for sm_90a into openmvg_torch/_build/ at first use and loaded with
ctypes (plain C interface, no PyTorch headers).

Contract, for each row of `a` over the valid rows of `b`:
  d1   smallest squared L2 distance, float32 (exact for uint8 input)
  idx1 its column, ties to the lowest index (int32)
  d2   the smallest over every column except idx1 (== d1 on a tie)
A row with no valid column gets (FLT_MAX, FLT_MAX, 0), as the reference's
masked argmin does.  In the pair-batch entry point, rows of `a` at or past
the view's count also get that value.

The wrappers take the plain version only for CPU tensors.  For a CUDA
tensor they launch the kernel or raise.
"""

import ctypes

import numpy as np
import torch

from openmvg_torch.utils.build import NVCC_FLAGS, build_shared, nvcc

FLT_MAX = float(np.finfo(np.float32).max)
MAX_D = 128
MAX_PAIRS = 65535  # grid.y

# Kernel launches since import (or since the caller last set it to 0).
LAUNCHES = 0
# ptxas report (registers, shared memory, spills) of the last build.
BUILD_LOG = ""

_lib = None


def build():
    """Compile the kernel (once per source/flags version) and load it."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    lib, BUILD_LOG = build_shared("two_nn.cu", nvcc(), NVCC_FLAGS)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("omt_two_nn_u8", "omt_two_nn_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 6 + [ci] * 7 + [vp] * 4
        fn.restype = ci
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# plain version (the reference for the kernel; the CPU path)
# ---------------------------------------------------------------------------

def l2_distance_matrix(a, b):
    """(..., N, D) x (..., M, D) -> (..., N, M) squared L2 in float32.

    uint8 pairs are shifted by -128; every partial sum is then an integer
    below 2^24, so the float32 result is exact whatever the summation order
    (this needs full-f32 matmuls: TF32 is off package-wide).  Float inputs
    are clamped at 0 like the reference."""
    if a.dtype == torch.uint8 and b.dtype == torch.uint8:
        af = a.to(torch.float32) - 128.0
        bf = b.to(torch.float32) - 128.0
        an = (af * af).sum(-1)
        bn = (bf * bf).sum(-1)
        return an[..., :, None] + bn[..., None, :] - 2.0 * (af @ bf.transpose(-1, -2))
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    an = (af * af).sum(-1)
    bn = (bf * bf).sum(-1)
    d = an[..., :, None] + bn[..., None, :] - 2.0 * (af @ bf.transpose(-1, -2))
    return torch.clamp(d, min=0.0)


def two_nn(dist, valid_cols=None):
    """Per-row (d1, d2, idx1) of a (..., N, M) distance matrix; invalid
    columns are FLT_MAX.  argmin returns the first minimum."""
    big = torch.tensor(FLT_MAX, dtype=dist.dtype, device=dist.device)
    if valid_cols is not None:
        dist = torch.where(valid_cols[..., None, :], dist, big)
    idx1 = torch.argmin(dist, dim=-1)
    d1 = torch.gather(dist, -1, idx1[..., None])[..., 0]
    d2 = dist.scatter(-1, idx1[..., None], FLT_MAX).min(dim=-1).values
    return d1, d2, idx1.to(torch.int32)


def two_nn_plain(a, b, valid_b=None):
    return two_nn(l2_distance_matrix(a, b), valid_b)


def two_nn_batch_plain(descs, counts, pairs):
    """Pair by pair, so one (Nmax, Nmax) distance matrix lives at a time."""
    P, nmax = pairs.shape[0], descs.shape[1]
    d1 = torch.full((P, nmax), FLT_MAX, dtype=torch.float32, device=descs.device)
    d2 = d1.clone()
    i1 = torch.zeros((P, nmax), dtype=torch.int32, device=descs.device)
    col = torch.arange(nmax, device=descs.device)
    for p, (i, j) in enumerate(pairs.tolist()):
        na = int(counts[i])
        r1, r2, ri = two_nn_plain(descs[i, :na], descs[j], col < counts[j])
        d1[p, :na], d2[p, :na], i1[p, :na] = r1, r2, ri
    return d1, d2, i1


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_descs(x, name):
    if x.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"{name}: dtype {x.dtype}; the kernel takes uint8 or float32")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    D = x.shape[-1]
    if not 0 < D <= MAX_D or (x.dtype == torch.uint8 and D % 4):
        raise ValueError(f"{name}: descriptor length {D}; the kernel takes "
                         f"1..{MAX_D} (a multiple of 4 for uint8)")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _launch(da, db, pairs, counts_a, counts_b, valid_b, n_out):
    global LAUNCHES
    lib = build()
    P = pairs.shape[0]
    dev = da.device
    d1 = torch.empty((P, n_out), dtype=torch.float32, device=dev)
    d2 = torch.empty((P, n_out), dtype=torch.float32, device=dev)
    i1 = torch.empty((P, n_out), dtype=torch.int32, device=dev)
    if P == 0 or n_out == 0:
        return d1, d2, i1
    if P > MAX_PAIRS:
        raise ValueError(f"{P} pairs in one launch; the kernel takes at most {MAX_PAIRS}")
    fn = lib.omt_two_nn_u8 if da.dtype == torch.uint8 else lib.omt_two_nn_f32
    err = fn(da.data_ptr(), db.data_ptr(), pairs.data_ptr(), counts_a.data_ptr(),
             counts_b.data_ptr(), valid_b.data_ptr() if valid_b is not None else None,
             da.shape[0], db.shape[0], da.shape[1], db.shape[1], da.shape[2], n_out, P,
             d1.data_ptr(), d2.data_ptr(), i1.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"two_nn kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return d1, d2, i1


def two_nn_batch(descs, counts, pairs):
    """Whole pair batch: descs (V, Nmax, D) uint8|float32, counts (V,) int32,
    pairs (P, 2) int32 -> d1, d2 (P, Nmax) float32, idx1 (P, Nmax) int32.
    Rows of view i at or past counts[i] are not descriptors; columns of view
    j at or past counts[j] never win."""
    if descs.dim() != 3 or counts.shape != (descs.shape[0],) or \
            pairs.dim() != 2 or pairs.shape[1] != 2:
        raise ValueError(f"shapes descs {tuple(descs.shape)}, counts "
                         f"{tuple(counts.shape)}, pairs {tuple(pairs.shape)}")
    if not (descs.device == counts.device == pairs.device):
        raise ValueError("descs, counts and pairs must be on one device")
    if descs.device.type == "cpu":
        return two_nn_batch_plain(descs, counts, pairs)
    if descs.device.type != "cuda":
        raise ValueError(f"unsupported device {descs.device}")
    _check_descs(descs, "descs")
    for t, name in ((counts, "counts"), (pairs, "pairs")):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous int32")
    return _launch(descs, descs, pairs, counts, counts, None, descs.shape[1])


def two_nn_fused(a, b, valid_b=None):
    """(N, D), (M, D) -> (d1, d2, idx1), each (N,): the signature of the
    reference's two_nn_fused, on the same device code as two_nn_batch."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}")
    if valid_b is not None and valid_b.shape != (b.shape[0],):
        raise ValueError(f"valid_b shape {tuple(valid_b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"dtypes {a.dtype} and {b.dtype} differ")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return two_nn_plain(a, b, valid_b)
    if not (a.device.type == b.device.type == "cuda") or a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}: both must be on "
                         "one CUDA device or both on the CPU")
    _check_descs(a, "a")
    _check_descs(b, "b")
    if valid_b is not None:
        if valid_b.dtype != torch.bool or valid_b.device != b.device or \
                not valid_b.is_contiguous():
            raise TypeError("valid_b must be a contiguous bool tensor beside b")
    N, M = a.shape[0], b.shape[0]
    dev = a.device
    pairs = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    ca = torch.tensor([N], dtype=torch.int32, device=dev)
    cb = torch.tensor([M], dtype=torch.int32, device=dev)
    d1, d2, i1 = _launch(a[None], b[None], pairs, ca, cb, valid_b, N)
    return d1[0], d2[0], i1[0]
