"""Kernel K2: deterministic segment sums, and their plain versions.

Counterpart: openmvg_tpu/ops/pallas_segsum.py::seg_sum_mxu (the Pallas TPU
kernel), together with the J-products its callers in openmvg_tpu/sfm/ba.py
(`_camera_rmatvec`, `_block_outer_seg`) formed before each call.  The CUDA
source is openmvg_torch/csrc/seg_sum.cu; it is built with nvcc for sm_90a
into openmvg_torch/_build/ at first use and loaded with ctypes (plain C
interface, no PyTorch headers).

Contracts.  Rows whose id lies outside [0, num) add nothing.
  seg_sum(vals, ids, num)  out[s] = sum of vals[i] over the rows with
      ids[i] == s, for vals (O, k) float32 or float64 with 1 <= k <= 64 and
      any num with num * k < 2^31 (the TPU kernel stopped at 1024
      segments, a limit of its one-hot tile; this one has none, so the
      point-side sums of a problem without a group table go through it too).
  camera_jtu(Jp6, Ji8, u, pose_ids, intr_ids, n_pose, n_intr)
      (gp (P, 6), gi (I, 8)): the sums of J_o^T u_o over each pose and each
      intrinsic segment, for Jp6 (O, 2, 6), Ji8 (O, 2, 8), u (O, 2).
  camera_jtj(Jp6, Ji8, pose_ids, intr_ids, n_pose, n_intr)
      (Hp (P, 6, 6), Hi (I, 8, 8)): the sums of J_o^T J_o.
The camera sums take float32 or float64.  Each call is one launch (none
when there is nothing to write).  The kernel uses no float atomics: a plan
(seg_sum_plan, built once per set of ids) sorts the valid rows by segment
and cuts each segment into chunks, and every output element is one fixed
sequence of additions, so two calls on the same input are bitwise equal
(see the source note in seg_sum.cu).  The plans carry int32 arrival
counters that each launch leaves at 0; a plan serves one stream at a time.

The wrappers take the plain versions only for CPU tensors.  For a CUDA
tensor they launch the kernel or raise.
"""

import ctypes
from typing import NamedTuple

import torch

from openmvg_torch.utils.build import NVCC_FLAGS, build_shared, nvcc

MAX_K = 64
CHUNK = 1024  # rows of one segment summed by one block

# Kernel launches since import (or since the caller last set it to 0): one
# a call, none when the call has no output to write.
LAUNCHES = 0
# ptxas report (registers, shared memory, spills) of the last build.
BUILD_LOG = ""

_lib = None
_PLAN_ARGS = 7 * [ctypes.c_void_p] + 3 * [ctypes.c_int]


def build():
    """Compile the kernel (once per source/flags version) and load it."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    lib, BUILD_LOG = build_shared("seg_sum.cu", nvcc(), NVCC_FLAGS)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("omt_seg_sum_f32", "omt_seg_sum_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] + _PLAN_ARGS + [ci] + [vp] * 3
        fn.restype = ci
    for name in ("omt_camera_sums_f32", "omt_camera_sums_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ci] + [vp] * 3 + 2 * _PLAN_ARGS + [vp] * 5
        fn.restype = ci
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# plain versions (the reference for the kernel; the CPU path)
# ---------------------------------------------------------------------------

def seg_sum_plain(vals, ids, num):
    """The same function in plain torch: rows with an id outside [0, num)
    go to a spill row that is dropped; index_add_ on a CPU tensor adds the
    rows in order."""
    k = vals.shape[1]
    key = torch.where((ids >= 0) & (ids < num), ids.long(), num)
    out = torch.zeros((num + 1, k), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, key, vals)[:num]


def brmatvec(J, u):
    """(O, 2, k) x (O, 2) -> (O, k): the rows J_o^T u_o."""
    return (J * u[:, :, None]).sum(1)


def outer_flat(J):
    """(O, 2, k) -> (O, k * k): the rows J_o^T J_o, flattened."""
    O, _, k = J.shape
    return (J[:, :, :, None] * J[:, :, None, :]).sum(1).reshape(O, k * k)


def camera_jtu_plain(Jp6, Ji8, u, pose_ids, intr_ids, n_pose, n_intr):
    return (seg_sum_plain(brmatvec(Jp6, u), pose_ids, n_pose),
            seg_sum_plain(brmatvec(Ji8, u), intr_ids, n_intr))


def camera_jtj_plain(Jp6, Ji8, pose_ids, intr_ids, n_pose, n_intr):
    return (seg_sum_plain(outer_flat(Jp6), pose_ids, n_pose).reshape(n_pose, 6, 6),
            seg_sum_plain(outer_flat(Ji8), intr_ids, n_intr).reshape(n_intr, 8, 8))


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

class SegSumPlan(NamedTuple):
    perm: torch.Tensor           # (n_valid,) int32 valid rows, by segment (stable)
    chunk_start: torch.Tensor    # (n_chunks,) int32 ranges into perm
    chunk_end: torch.Tensor      # (n_chunks,) int32
    seg_chunk_off: torch.Tensor  # (num + 1,) int32 first chunk of each segment
    num: int
    n_rows: int                  # row count of the vals the plan applies to
    chunk_seg: torch.Tensor      # (n_chunks,) int32 segment of each chunk
    empty: torch.Tensor          # (n_empty,) int32 segments without a row
    counters: torch.Tensor       # (num,) int32 arrival counters, 0 between launches


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
                      num=int(num), n_rows=int(ids.shape[0]),
                      chunk_seg=chunk_seg.to(i32).contiguous(),
                      empty=torch.nonzero(counts == 0)[:, 0].to(i32).contiguous(),
                      counters=torch.zeros(num, dtype=i32, device=dev))


def _plan_args(plan):
    return [plan.perm.data_ptr(), plan.chunk_start.data_ptr(), plan.chunk_end.data_ptr(),
            plan.chunk_seg.data_ptr(), plan.seg_chunk_off.data_ptr(), plan.empty.data_ptr(),
            plan.counters.data_ptr(), plan.chunk_start.shape[0], plan.empty.shape[0],
            plan.num]


def _check_plan(plan, num, n_rows, dev):
    if plan.num != num or plan.n_rows != n_rows or plan.perm.device != dev:
        raise ValueError("the plan was built for other ids, num or device")


def _check_cuda_floats(tensors):
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype {dtype}; the kernel takes float32 or float64")
    for t in tensors:
        if t.dtype != dtype or t.device != tensors[0].device:
            raise ValueError("every input must share one dtype and one device")
        if t.data_ptr() % 16:
            raise ValueError("inputs must start on a 16-byte boundary")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

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
    _check_plan(plan, num, O, vals.device)
    vals = vals.contiguous()
    out = torch.empty((num, k), dtype=vals.dtype, device=vals.device)
    if num == 0:
        return out
    partial = torch.empty((max(plan.chunk_start.shape[0], 1), k), dtype=vals.dtype,
                          device=vals.device)
    lib = build()
    fn = lib.omt_seg_sum_f32 if vals.dtype == torch.float32 else lib.omt_seg_sum_f64
    err = fn(vals.data_ptr(), *_plan_args(plan), k, partial.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream(vals.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"seg_sum kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def _camera(mode, Jp6, Ji8, u, pose_ids, intr_ids, n_pose, n_intr, plans):
    """One launch of the fused camera sums (mode 0 J^T u, 1 J^T J)."""
    global LAUNCHES
    O = Jp6.shape[0]
    if Jp6.shape != (O, 2, 6) or Ji8.shape != (O, 2, 8) or \
            pose_ids.shape != (O,) or intr_ids.shape != (O,) or \
            (u is not None and u.shape != (O, 2)):
        raise ValueError(f"shapes Jp6 {tuple(Jp6.shape)}, Ji8 {tuple(Ji8.shape)}, "
                         f"ids {tuple(pose_ids.shape)} / {tuple(intr_ids.shape)}")
    every = [Jp6, Ji8, pose_ids, intr_ids] + ([u] if u is not None else [])
    if any(t.device.type == "cpu" for t in every):
        if not all(t.device.type == "cpu" for t in every):
            raise ValueError("every input must be on one device")
        if mode == 0:
            return camera_jtu_plain(Jp6, Ji8, u, pose_ids, intr_ids, n_pose, n_intr)
        return camera_jtj_plain(Jp6, Ji8, pose_ids, intr_ids, n_pose, n_intr)
    if Jp6.device.type != "cuda":
        raise ValueError(f"unsupported device {Jp6.device}")
    Jp6, Ji8 = Jp6.contiguous(), Ji8.contiguous()
    u = u.contiguous() if u is not None else None
    _check_cuda_floats([Jp6, Ji8] + ([u] if u is not None else []))
    if pose_ids.device != Jp6.device or intr_ids.device != Jp6.device:
        raise ValueError("every input must be on one device")
    if O >= 2 ** 31 // 16:
        raise ValueError(f"{O} rows: row offsets must fit int32")
    for n in (n_pose, n_intr):
        if not 0 <= n < 2 ** 31 // 64:
            raise ValueError(f"{n} segments: output ids must fit int32")
    plan_p, plan_i = plans if plans is not None else (None, None)
    plan_p = plan_p if plan_p is not None else seg_sum_plan(pose_ids, n_pose)
    plan_i = plan_i if plan_i is not None else seg_sum_plan(intr_ids, n_intr)
    dev, dt = Jp6.device, Jp6.dtype
    _check_plan(plan_p, n_pose, O, dev)
    _check_plan(plan_i, n_intr, O, dev)
    if n_pose and n_intr and plan_p.counters.data_ptr() == plan_i.counters.data_ptr():
        raise ValueError("the two halves need plans of their own: one launch counts both "
                         "on their plans' arrival counters")
    wp, wi = (6, 8) if mode == 0 else (21, 36)
    shape_p, shape_i = ((n_pose, 6), (n_intr, 8)) if mode == 0 else \
        ((n_pose, 6, 6), (n_intr, 8, 8))
    out_p = torch.empty(shape_p, dtype=dt, device=dev)
    out_i = torch.empty(shape_i, dtype=dt, device=dev)
    if n_pose + n_intr == 0:
        return out_p, out_i
    part_p = torch.empty((max(plan_p.chunk_start.shape[0], 1), wp), dtype=dt, device=dev)
    part_i = torch.empty((max(plan_i.chunk_start.shape[0], 1), wi), dtype=dt, device=dev)
    lib = build()
    fn = lib.omt_camera_sums_f32 if dt == torch.float32 else lib.omt_camera_sums_f64
    err = fn(mode, Jp6.data_ptr(), Ji8.data_ptr(), u.data_ptr() if u is not None else None,
             *_plan_args(plan_p), *_plan_args(plan_i), part_p.data_ptr(), part_i.data_ptr(),
             out_p.data_ptr(), out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"camera sums kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out_p, out_i


def camera_jtu(Jp6, Ji8, u, pose_ids, intr_ids, n_pose, n_intr, plans=None):
    """(gp (P, 6), gi (I, 8)) = the sums of J_o^T u_o over the pose and the
    intrinsic segments, one launch on the card.  `plans`: the (pose,
    intrinsic) seg_sum_plan pair of these ids, built once per problem."""
    return _camera(0, Jp6, Ji8, u, pose_ids, intr_ids, n_pose, n_intr, plans)


def camera_jtj(Jp6, Ji8, pose_ids, intr_ids, n_pose, n_intr, plans=None):
    """(Hp (P, 6, 6), Hi (I, 8, 8)) = the sums of J_o^T J_o, one launch on
    the card; symmetric bit for bit."""
    return _camera(1, Jp6, Ji8, None, pose_ids, intr_ids, n_pose, n_intr, plans)
