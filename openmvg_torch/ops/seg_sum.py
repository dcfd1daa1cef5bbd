"""Kernel K2: deterministic segment sum, and its plain version.

Counterpart: openmvg_tpu/ops/pallas_segsum.py::seg_sum_mxu (the Pallas TPU
kernel).  The CUDA source is openmvg_torch/csrc/seg_sum.cu; it is built
with nvcc for sm_90a into openmvg_torch/_build/ at first use and loaded
with ctypes (plain C interface, no PyTorch headers).

Contract: out[s] = sum of vals[i] over the rows i with ids[i] == s, for
vals (O, k) float32 or float64 with 1 <= k <= 64 and any num with
num * k < 2^31 (the TPU kernel stopped at 1024 segments, a limit of its
one-hot tile; this one has none, so the point-side sums of a problem
without a group table go through it too); rows whose id lies outside
[0, num) add nothing.  The kernel uses no atomics: a plan (seg_sum_plan,
built once per set of ids) sorts the valid rows by segment and cuts each
segment into chunks, and every output element is one fixed sequence of
additions, so two calls on the same input are bitwise equal (see the
source note in seg_sum.cu).

seg_sum takes the plain version only for CPU tensors.  For a CUDA tensor
it launches the kernel or raises.
"""

import ctypes
from typing import NamedTuple

import torch

from openmvg_torch.utils.build import NVCC_FLAGS, build_shared, nvcc

MAX_K = 64
CHUNK = 1024  # rows of one segment summed by one block in pass 1

# Kernel launches since import (or since the caller last set it to 0): a
# call is two launches (seg_sum_chunks, seg_sum_fold), or one when no row
# is valid.
LAUNCHES = 0
# ptxas report (registers, shared memory, spills) of the last build.
BUILD_LOG = ""

_lib = None


def build():
    """Compile the kernel (once per source/flags version) and load it."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    lib, BUILD_LOG = build_shared("seg_sum.cu", nvcc(), NVCC_FLAGS)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("omt_seg_sum_f32", "omt_seg_sum_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 5 + [ci] * 3 + [vp] * 3
        fn.restype = ci
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# plain version (the reference for the kernel; the CPU path)
# ---------------------------------------------------------------------------

def seg_sum_plain(vals, ids, num):
    """The same function in plain torch: rows with an id outside [0, num)
    go to a spill row that is dropped; index_add_ on a CPU tensor adds the
    rows in order."""
    k = vals.shape[1]
    key = torch.where((ids >= 0) & (ids < num), ids.long(), num)
    out = torch.zeros((num + 1, k), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, key, vals)[:num]


# ---------------------------------------------------------------------------
# plan + wrapper
# ---------------------------------------------------------------------------

class SegSumPlan(NamedTuple):
    perm: torch.Tensor           # (n_valid,) int32 valid rows, by segment (stable)
    chunk_start: torch.Tensor    # (n_chunks,) int32 ranges into perm
    chunk_end: torch.Tensor      # (n_chunks,) int32
    seg_chunk_off: torch.Tensor  # (num + 1,) int32 first chunk of each segment
    num: int
    n_rows: int                  # row count of the vals the plan applies to


def seg_sum_plan(ids, num, chunk=CHUNK):
    """Stable counting sort of the valid rows of `ids` (O,) by segment, and
    each segment's run cut into chunks of at most `chunk` rows.  Integer
    work only (the same on every run); built once per BA problem, since the
    ids are fixed across the LM loop."""
    if not 0 <= num < 2 ** 31 // MAX_K:
        raise ValueError(f"num = {num}; the plan takes 0..{2 ** 31 // MAX_K - 1} segments")
    dev = ids.device
    key = torch.where((ids >= 0) & (ids < num), ids.long(), num)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=num + 1)[:num]
    offs = torch.zeros(num + 1, dtype=torch.int64, device=dev)
    offs[1:] = torch.cumsum(counts, 0)
    nch = (counts + chunk - 1) // chunk
    seg_chunk_off = torch.zeros(num + 1, dtype=torch.int64, device=dev)
    seg_chunk_off[1:] = torch.cumsum(nch, 0)
    n_valid, n_chunks = (int(v) for v in torch.stack([offs[-1], seg_chunk_off[-1]]).tolist())
    chunk_seg = torch.repeat_interleave(torch.arange(num, device=dev), nch,
                                        output_size=n_chunks)
    local = torch.arange(n_chunks, device=dev) - seg_chunk_off[chunk_seg]
    start = offs[chunk_seg] + local * chunk
    end = torch.minimum(start + chunk, offs[chunk_seg + 1])
    i32 = torch.int32
    return SegSumPlan(perm=order[:n_valid].to(i32).contiguous(),
                      chunk_start=start.to(i32).contiguous(),
                      chunk_end=end.to(i32).contiguous(),
                      seg_chunk_off=seg_chunk_off.to(i32).contiguous(),
                      num=int(num), n_rows=int(ids.shape[0]))


def seg_sum(vals, ids, num, plan=None):
    """(O, k) vals, (O,) int ids -> (num, k) segment sums.  `plan` (from
    seg_sum_plan of the same ids and num) saves the sort on repeated calls
    with the same ids."""
    global LAUNCHES
    if vals.dim() != 2 or ids.shape != (vals.shape[0],):
        raise ValueError(f"shapes vals {tuple(vals.shape)}, ids {tuple(ids.shape)}")
    if vals.device != ids.device:
        raise ValueError("vals and ids must be on one device")
    if vals.device.type == "cpu":
        return seg_sum_plain(vals, ids, num)
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    if vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"vals dtype {vals.dtype}; the kernel takes float32 or float64")
    O, k = vals.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k = {k}; the kernel takes 1..{MAX_K} columns")
    if not 0 <= num < 2 ** 31 // k:
        raise ValueError(f"num = {num} of {k} columns: output ids must fit int32")
    if O >= 2 ** 31 // k:
        raise ValueError(f"{O} rows of {k}: row ids must fit int32")
    if plan is None:
        plan = seg_sum_plan(ids, num)
    if plan.num != num or plan.n_rows != O or plan.perm.device != vals.device:
        raise ValueError("the plan was built for other ids, num or device")
    vals = vals.contiguous()
    n_chunks = plan.chunk_start.shape[0]
    out = torch.empty((num, k), dtype=vals.dtype, device=vals.device)
    if num == 0:
        return out
    partial = torch.empty((max(n_chunks, 1), k), dtype=vals.dtype, device=vals.device)
    lib = build()
    fn = lib.omt_seg_sum_f32 if vals.dtype == torch.float32 else lib.omt_seg_sum_f64
    err = fn(vals.data_ptr(), plan.perm.data_ptr(), plan.chunk_start.data_ptr(),
             plan.chunk_end.data_ptr(), plan.seg_chunk_off.data_ptr(), n_chunks, num, k,
             partial.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream(vals.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"seg_sum kernel launch failed: cudaError {err}")
    LAUNCHES += 2 if n_chunks > 0 else 1
    return out
