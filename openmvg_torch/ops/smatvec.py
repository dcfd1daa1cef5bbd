"""Kernel K3: the fused S-matvec of the Schur-CG solve, its plan, and its
plain version.

Counterpart: openmvg_tpu/ops/pallas_smatvec.py::s_matvec_halves (the Pallas
TPU kernels `_kernel_a` and `_kernel_b`, with the helpers `pack_slots` and
`plan`).  The CUDA source is openmvg_torch/csrc/smatvec.cu (with K2's device
code from csrc/seg_sum.cuh); it is built with nvcc for sm_90a into
openmvg_torch/_build/ at first use and loaded with ctypes (plain C
interface, no PyTorch headers).

Contract: for the reduced camera system of a bundle adjustment in the
point-major layout (sfm/ba.py::point_major_layout: O = L1 * R slots, row r
owning slots [r R, (r + 1) R), all of point row_point[r]),

    (sp (P, 6), si (I, 8)) = Jc^T e,   e = u - Jx Hpp^-1 Jx^T u,   u = Jc v,

v = (vp (P, 6), vi (I, 8)), Jc = [Jp | Ji] per slot; the caller adds the
O(P) terms lam D v and Hprior v.  The rows are folded into their points
(row_point); the plain versions fold them through a group table groups
(L, M), whose entries outside [0, L1) add nothing, or through row_point
where groups is None.  The kernel reads no group table.  Ids outside
[0, P) or [0, I) contribute nothing.

Two input forms.  The reference packs every slot into one (O, 36) float32
row [Jp 12 | Ji 16 | Jx 6 | pose id | intrinsic id] (pack_slots) so that
Pallas stages one 128-lane tile; parity tests feed that form to both
packages through unpack_slots.  The kernel and smatvec read the blocks and
the int32 ids directly: jp (O, 2, 6) or (O, 12), ji (O, 2, 8) or (O, 16),
jx (O, 2, 3) or (O, 6), float32.

The kernel is two launches a call (see the note of smatvec.cu): a pass over
tiles of whole points that writes e (O, 2), then kernel K2's camera sums of
J^T e.  smatvec_plan, built once per problem (sfm/ba.py::with_plans,
beside K2's plans), holds what does not change between the CG iterations
and the LM steps: the int32 ids, the tile plan (tile_plan, which also
checks on the device that row_point is the contiguous point-major form
that sfm/ba.py::build_pt_obs makes, and raises ValueError otherwise),
kernel K2's plans of the pose and intrinsic ids, and on the card the e
buffer, K2's chunk partials and the checks of the ids and tables, so that
a call checks only its float inputs and allocates only its two outputs.
Like K2's arrival counters, that scratch serves one stream at a time: a
plan must not serve two calls in flight on two streams.

smatvec takes the plain version only for CPU tensors.  For a CUDA tensor it
launches the kernel or raises; there is no fallback.
"""

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from openmvg_torch.ops import seg_sum as k2
from openmvg_torch.utils.build import NVCC_FLAGS, build_shared, nvcc

PACK_F = 36                       # [jp 0:12 | ji 12:28 | jx 28:34 | ids 34:36]
TILE = 1024                       # slots of one tile (smatvec.cu kTile)

# Kernel launches since import (or since the caller last set it to 0): a
# call is two launches (the point-owned tiles, then K2's camera sums on e;
# K2's own LAUNCHES does not count the second); a call without poses and
# intrinsics launches nothing.
LAUNCHES = 0
# ptxas report (registers, shared memory, spills) of the last build.
BUILD_LOG = ""

_lib = None


def build():
    """Compile the kernel (once per source/flags version) and load it."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    lib, BUILD_LOG = build_shared("smatvec.cu", nvcc(), NVCC_FLAGS)
    fn = lib.omt_smatvec_f32
    fn.argtypes = [ctypes.POINTER(_Tables)] + [ctypes.c_void_p] * 9
    fn.restype = ctypes.c_int
    for fn in (lib.omt_smatvec_tile_slots, lib.omt_smatvec_tables_bytes):
        fn.argtypes, fn.restype = [], ctypes.c_int
    if lib.omt_smatvec_tile_slots() != TILE or \
            lib.omt_smatvec_tables_bytes() != ctypes.sizeof(_Tables):
        raise RuntimeError("smatvec.cu and ops/smatvec.py disagree on the tile size or "
                           "the table layout")
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# the packed form, and the plain version (the reference for the kernel; the
# CPU path)
# ---------------------------------------------------------------------------

def pack_slots(jp, ji, jx, pose_ids, intr_ids):
    """The reference's (O, 36) float32 per-slot rows."""
    O = jp.shape[0]
    return torch.cat([jp.reshape(O, 12), ji.reshape(O, 16), jx.reshape(O, 6),
                      pose_ids.to(torch.float32)[:, None],
                      intr_ids.to(torch.float32)[:, None]], 1)


def unpack_slots(packed):
    """(jp (O, 12), ji (O, 16), jx (O, 6), pose ids, intrinsic ids)."""
    return (packed[:, 0:12], packed[:, 12:28], packed[:, 28:34], packed[:, 34].long(),
            packed[:, 35].long())


def _e(jp, ji, jx, pose_ids, intr_ids, vp, vi, hpp_inv, row_point, groups, sign):
    O, L1 = jp.shape[0], row_point.shape[0]
    R, L = O // L1, hpp_inv.shape[0]
    P, I = vp.shape[0], vi.shape[0]
    jp, ji, jx = jp.reshape(O, 2, 6), ji.reshape(O, 2, 8), jx.reshape(O, 2, 3)
    pose_ok = (pose_ids >= 0) & (pose_ids < P)
    intr_ok = (intr_ids >= 0) & (intr_ids < I)
    vpo = torch.where(pose_ok[:, None], vp[pose_ids.clamp(0, max(P - 1, 0))], 0.0)
    vio = torch.where(intr_ok[:, None], vi[intr_ids.clamp(0, max(I - 1, 0))], 0.0)
    u = (jp * vpo[:, None]).sum(-1) + (ji * vio[:, None]).sum(-1)             # (O, 2)
    rows = (jx * u[:, :, None]).sum(1).reshape(L1, R, 3).sum(1)                # (L1, 3)
    if groups is None:
        pts = rows.new_zeros((L, 3)).index_add_(0, row_point.long(), rows)
    else:
        rs = torch.cat([rows, rows.new_zeros((1, 3))])
        g = torch.where((groups >= 0) & (groups < L1), groups.long(), L1)
        pts = rs[g].sum(1)
    y = torch.einsum("lij,lj->li", hpp_inv, pts)                               # (L, 3)
    y_slot = y[row_point.long().clamp(0, L - 1)].repeat_interleave(R, 0)      # (O, 3)
    return u + sign * (jx * y_slot[:, None, :]).sum(-1)


def _plain(jp, ji, jx, pose_ids, intr_ids, vp, vi, hpp_inv, row_point, groups, sign):
    O = jp.shape[0]
    e = _e(jp, ji, jx, pose_ids, intr_ids, vp, vi, hpp_inv, row_point, groups, sign)
    return k2.camera_jtu_plain(jp.reshape(O, 2, 6), ji.reshape(O, 2, 8), e, pose_ids,
                               intr_ids, vp.shape[0], vi.shape[0])


def smatvec_e_plain(jp, ji, jx, pose_ids, intr_ids, vp, vi, hpp_inv, row_point, groups):
    """e = u - Jx Hpp^-1 Jx^T u (O, 2), what the kernel's first launch
    writes, in plain torch; K2's camera_jtu_plain of it is smatvec_plain."""
    return _e(jp, ji, jx, pose_ids, intr_ids, vp, vi, hpp_inv, row_point, groups, -1.0)


def smatvec_e_magnitudes(jp, ji, jx, pose_ids, intr_ids, vp, vi, hpp_inv, row_point, groups):
    """The sum of magnitudes behind each entry of e (see
    smatvec_magnitudes)."""
    return _e(jp.abs(), ji.abs(), jx.abs(), pose_ids, intr_ids, vp.abs(), vi.abs(),
              hpp_inv.abs(), row_point, groups, 1.0)


def smatvec_plain(jp, ji, jx, pose_ids, intr_ids, vp, vi, hpp_inv, row_point, groups):
    """The same function in plain torch, in the dtype of its inputs (the
    CPU path, and the reference the kernel is held to)."""
    return _plain(jp, ji, jx, pose_ids, intr_ids, vp, vi, hpp_inv, row_point, groups, -1.0)


def smatvec_magnitudes(jp, ji, jx, pose_ids, intr_ids, vp, vi, hpp_inv, row_point, groups):
    """S, the sum of magnitudes behind each output: the plain version on
    |inputs| with the one difference taken as a sum.  A float32 result's
    rounding scales with S, not with the output, which can cancel."""
    return _plain(jp.abs(), ji.abs(), jx.abs(), pose_ids, intr_ids, vp.abs(), vi.abs(),
                  hpp_inv.abs(), row_point, groups, 1.0)


# ---------------------------------------------------------------------------
# plan + wrapper
# ---------------------------------------------------------------------------

_PTRS = ("pose_ids", "intr_ids", "pt_row0", "tiles", "e", "part_p", "part_i",
         "p_perm", "p_start", "p_end", "p_seg", "p_off", "p_empty", "p_counters",
         "i_perm", "i_start", "i_end", "i_seg", "i_off", "i_empty", "i_counters")
_INTS = ("O", "R", "L1", "L", "n_tiles", "n_pose", "n_intr",
         "p_n_chunks", "p_n_empty", "i_n_chunks", "i_n_empty")


class _Tables(ctypes.Structure):
    """smatvec.cu's K3Tables: the plan's device pointers and counts, handed
    to the kernel as one pointer."""
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int32) for n in _INTS]


class SmatvecPlan(NamedTuple):
    pose_ids: torch.Tensor     # (O,) int32
    intr_ids: torch.Tensor     # (O,) int32
    n_rows: int                # L1
    plan_p: k2.SegSumPlan      # K2 plan of pose_ids over n_pose segments
    plan_i: k2.SegSumPlan      # K2 plan of intr_ids over n_intr segments
    pt_row0: torch.Tensor      # (L + 1,) int32 first row of each point
    tiles: torch.Tensor        # (n_tiles, 4) int32 first row, end row, first point, end point
    e: Optional[torch.Tensor] = None        # (O, 2) float32 scratch (card only)
    part_p: Optional[torch.Tensor] = None   # K2 chunk partials of the pose half
    part_i: Optional[torch.Tensor] = None
    tables: Optional[_Tables] = None        # the pointers above, for the kernel
    sizes: tuple = ()                       # element counts of jp, ji, jx, vp, vi, hpp_inv


def tile_plan(row_point, n_points, n_slots, tile=TILE):
    """Check that row_point is the contiguous point-major form that
    sfm/ba.py::build_pt_obs makes, and cut the rows into tiles at point
    boundaries.  The form: R = n_slots / L1 a power of two up to 32;
    row_point runs 0, .., n_points - 1 in steps of 0 or 1, so that each
    point owns a run of rows of its own, in point order.  Tiles take whole
    points greedily, in order, up to `tile` slots; a point of more slots
    than that gets a tile to itself.  The check runs as elementwise ops on
    row_point's device; the host reads only each point's first row (L + 1
    ints) and the verdict, in one copy, and cuts the tiles from them.
    Returns (pt_row0 (L + 1,), tiles (n_tiles, 4): first row, end row,
    first point, end point), int32 on row_point's device; raises
    ValueError for any other form."""
    L1, L = row_point.shape[0], int(n_points)
    if row_point.dim() != 1 or L1 == 0 or L == 0 or n_slots % L1:
        raise ValueError(f"{n_slots} slots, {L1} rows and {L} points do not form a "
                         f"point-major layout")
    R = n_slots // L1
    if R > 32 or R & (R - 1):
        raise ValueError(f"{R} slots a row: the kernel takes a power of two up to 32")
    dev = row_point.device
    rp = row_point.to(dtype=torch.int64).contiguous()
    # off[l] is point l's first row, off[L] = L1
    off = torch.searchsorted(rp, torch.arange(L + 1, device=dev))
    step = rp[1:] - rp[:-1]
    ok = (rp[0] == 0) & (rp[-1] == L - 1) & ((step == 0) | (step == 1)).all()
    host = torch.cat([off, ok.long()[None]]).cpu().numpy()
    if not host[-1]:
        raise ValueError("row_point is not the contiguous point-major form of "
                         "sfm/ba.py::build_pt_obs (each point's rows in a run of its own, "
                         "in point order)")
    off_h = host[:-1]
    ends = off_h[1:] * R
    tiles = []
    l = 0
    while l < L:
        l2 = max(int(np.searchsorted(ends, off_h[l] * R + tile, side="right")), l + 1)
        tiles.append((off_h[l], off_h[l2], l, l2))
        l = l2
    return (off.to(torch.int32),
            torch.as_tensor(np.asarray(tiles, np.int64).reshape(-1, 4),
                            dtype=torch.int32).to(dev))


def smatvec_plan(pose_ids, intr_ids, row_point, n_points, n_pose, n_intr, seg_plans=None):
    """The kernel's int32 tables, tile plan and K2 plans (seg_plans: the
    (pose, intrinsic) K2 plans a bundle adjustment problem already holds),
    and on the card its scratch, for n_points points.  Every check that
    does not depend on a call's vectors and blocks is made here, once.
    Raises ValueError when row_point is not the contiguous point-major
    form (tile_plan) or the ids do not fit the kernel."""
    i32 = torch.int32
    O = pose_ids.shape[0]
    pt_row0, tiles = tile_plan(row_point, n_points, O)
    plan_p, plan_i = seg_plans if seg_plans is not None else (
        k2.seg_sum_plan(pose_ids, n_pose), k2.seg_sum_plan(intr_ids, n_intr))
    plan = SmatvecPlan(pose_ids=pose_ids.to(i32).contiguous(),
                       intr_ids=intr_ids.to(i32).contiguous(), n_rows=row_point.shape[0],
                       plan_p=plan_p, plan_i=plan_i, pt_row0=pt_row0, tiles=tiles)
    if pose_ids.device.type != "cuda":
        return plan
    dev, L = pose_ids.device, int(n_points)
    if (intr_ids.shape != (O,) or pose_ids.dim() != 1
            or any(t.device != dev for t in (intr_ids, row_point))):
        raise ValueError("the ids and tables must be (O,) ids and tables on one device")
    if O >= 2 ** 31 // 16:
        raise ValueError(f"{O} slots: slot offsets must fit int32")
    if (plan_p.num != n_pose or plan_i.num != n_intr or plan_p.n_rows != O
            or plan_i.n_rows != O or plan_p.perm.device != dev or plan_i.perm.device != dev):
        raise ValueError("the K2 plans were built for other ids, counts or device")
    if n_pose and n_intr and plan_p.counters.data_ptr() == plan_i.counters.data_ptr():
        raise ValueError("the two halves need K2 plans of their own: one launch counts both "
                         "on their plans' arrival counters")
    f32 = torch.float32
    plan = plan._replace(
        e=torch.empty((O, 2), dtype=f32, device=dev),
        part_p=torch.empty((max(plan_p.chunk_start.shape[0], 1), 6), dtype=f32, device=dev),
        part_i=torch.empty((max(plan_i.chunk_start.shape[0], 1), 8), dtype=f32, device=dev))
    ptr = {"pose_ids": plan.pose_ids, "intr_ids": plan.intr_ids, "pt_row0": pt_row0,
           "tiles": tiles, "e": plan.e, "part_p": plan.part_p, "part_i": plan.part_i}
    for h, kp in (("p", plan_p), ("i", plan_i)):
        ptr.update({f"{h}_perm": kp.perm, f"{h}_start": kp.chunk_start,
                    f"{h}_end": kp.chunk_end, f"{h}_seg": kp.chunk_seg,
                    f"{h}_off": kp.seg_chunk_off, f"{h}_empty": kp.empty,
                    f"{h}_counters": kp.counters})
    ints = dict(O=O, R=O // plan.n_rows, L1=plan.n_rows, L=L,
                n_tiles=tiles.shape[0], n_pose=n_pose, n_intr=n_intr,
                p_n_chunks=plan_p.chunk_start.shape[0], p_n_empty=plan_p.empty.shape[0],
                i_n_chunks=plan_i.chunk_start.shape[0], i_n_empty=plan_i.empty.shape[0])
    tables = _Tables(*[ptr[n].data_ptr() for n in _PTRS], *[ints[n] for n in _INTS])
    # the element count of each float input a call hands the kernel
    sizes = (O * 12, O * 16, O * 6, n_pose * 6, n_intr * 8, L * 9)
    return plan._replace(tables=tables, sizes=sizes)


def smatvec(jp, ji, jx, pose_ids, intr_ids, vp, vi, hpp_inv, row_point, groups, plan=None):
    """(sp (P, 6), si (I, 8)) of the contract above (groups, or None, is
    read by the plain version only).  `plan` (smatvec_plan of the same ids
    and rows) saves its construction on repeated calls,
    and then the ids and tables are not read again; a call checks only
    its float inputs against the plan.  After a call on the card, plan.e
    holds the call's e."""
    global LAUNCHES
    O = jp.shape[0]
    L1 = row_point.shape[0]
    if L1 == 0 or O % L1:
        raise ValueError(f"{O} slots do not form {L1} rows of the point-major layout")
    if jp.device.type == "cpu":
        return smatvec_plain(jp, ji, jx, pose_ids, intr_ids, vp, vi, hpp_inv, row_point,
                             groups)
    if jp.device.type != "cuda":
        raise ValueError(f"unsupported device {jp.device}")
    if plan is None:
        plan = smatvec_plan(pose_ids, intr_ids, row_point, hpp_inv.shape[0], vp.shape[0],
                            vi.shape[0])
    if plan.tables is None or plan.e.device != jp.device:
        raise ValueError("the plan was built for another device")
    f32 = [jp, ji, jx, vp, vi, hpp_inv]
    for k, (t, n) in enumerate(zip(f32, plan.sizes)):
        if t.dtype != torch.float32:
            raise TypeError("the kernel takes float32 Jacobians, vectors and point blocks")
        if t.device != jp.device or t.numel() != n:
            raise ValueError("the inputs do not match the plan's counts or device (see the "
                             "module note)")
        f32[k] = t.contiguous()
    jp, ji, jx, vp, vi, hpp_inv = f32
    if jp.data_ptr() % 16 or ji.data_ptr() % 16 or jx.data_ptr() % 8:
        raise ValueError("jp and ji must start on a 16-byte boundary, jx on an 8-byte one")
    P, I = plan.plan_p.num, plan.plan_i.num
    sp = torch.empty((P, 6), dtype=torch.float32, device=jp.device)
    si = torch.empty((I, 8), dtype=torch.float32, device=jp.device)
    if P + I == 0:
        return sp, si
    err = build().omt_smatvec_f32(
        ctypes.byref(plan.tables), jp.data_ptr(), ji.data_ptr(), jx.data_ptr(), vp.data_ptr(),
        vi.data_ptr(), hpp_inv.data_ptr(), sp.data_ptr(), si.data_ptr(),
        torch.cuda.current_stream(jp.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"smatvec kernel launch failed: cudaError {err}")
    LAUNCHES += 2
    return sp, si
