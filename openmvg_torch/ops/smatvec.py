"""Kernel K3: the fused S-matvec of the Schur-CG solve, its plan, and its
plain version.

Counterpart: openmvg_tpu/ops/pallas_smatvec.py::s_matvec_halves (the Pallas
TPU kernels `_kernel_a` and `_kernel_b`, with the helpers `pack_slots` and
`plan`).  The CUDA source is openmvg_torch/csrc/smatvec.cu; it is built with
nvcc for sm_90a into openmvg_torch/_build/ at first use and loaded with
ctypes (plain C interface, no PyTorch headers).

Contract: for the reduced camera system of a bundle adjustment in the
point-major layout (sfm/ba.py::point_major_layout: O = L1 * R slots, row r
owning slots [r R, (r + 1) R), all of point row_point[r]),

    (sp (P, 6), si (I, 8)) = Jc^T (u - Jx Hpp^-1 Jx^T u),   u = Jc v,

v = (vp (P, 6), vi (I, 8)), Jc = [Jp | Ji] per slot; the caller adds the
O(P) terms lam D v and Hprior v.  The rows are folded into points through
the group table groups (L, M), whose entries >= L1 add nothing.  Ids
outside [0, P) or [0, I) contribute nothing.

Two input forms.  The reference packs every slot into one (O, 36) float32
row [Jp 12 | Ji 16 | Jx 6 | pose id | intrinsic id] (pack_slots) so that
Pallas stages one 128-lane tile; parity tests feed that form to both
packages through unpack_slots.  The kernel and smatvec read the blocks and
the int32 ids directly: jp (O, 2, 6) or (O, 12), ji (O, 2, 8) or (O, 16),
jx (O, 2, 3) or (O, 6), float32.  smatvec_plan holds the int32 copies and
kernel K2's plans of the pose and intrinsic ids (the kernel's last pass runs
over them), built once per solve.

smatvec takes the plain version only for CPU tensors.  For a CUDA tensor it
launches the kernel or raises; there is no fallback.
"""

import ctypes
from typing import NamedTuple

import torch

from openmvg_torch.ops import seg_sum as k2
from openmvg_torch.utils.build import NVCC_FLAGS, build_shared, nvcc

PACK_F = 36                       # [jp 0:12 | ji 12:28 | jx 28:34 | ids 34:36]

# Kernel launches since import (or since the caller last set it to 0): a
# call is four launches (rows, points, camera chunks, fold); one with
# nothing to do is skipped.
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
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.omt_smatvec_f32
    fn.argtypes = [vp] * 18 + [ci] * 8 + [vp] * 7
    fn.restype = ci
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


def _plain(jp, ji, jx, pose_ids, intr_ids, vp, vi, hpp_inv, row_point, groups, sign):
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
    rs = torch.cat([rows, rows.new_zeros((1, 3))])
    g = torch.where((groups >= 0) & (groups < L1), groups.long(), L1)
    y = torch.einsum("lij,lj->li", hpp_inv, rs[g].sum(1))                      # (L, 3)
    y_slot = y[row_point.long().clamp(0, L - 1)].repeat_interleave(R, 0)      # (O, 3)
    e = u + sign * (jx * y_slot[:, None, :]).sum(-1)
    return (k2.seg_sum_plain((jp * e[:, :, None]).sum(1), pose_ids, P),
            k2.seg_sum_plain((ji * e[:, :, None]).sum(1), intr_ids, I))


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

class SmatvecPlan(NamedTuple):
    pose_ids: torch.Tensor     # (O,) int32
    intr_ids: torch.Tensor     # (O,) int32
    row_point: torch.Tensor    # (L1,) int32
    groups: torch.Tensor       # (L, M) int32
    plan_p: k2.SegSumPlan      # K2 plan of pose_ids over n_pose segments
    plan_i: k2.SegSumPlan      # K2 plan of intr_ids over n_intr segments


def smatvec_plan(pose_ids, intr_ids, row_point, groups, n_pose, n_intr, seg_plans=None):
    """The kernel's int32 tables and K2 plans (seg_plans: the (pose,
    intrinsic) K2 plans a bundle adjustment problem already holds)."""
    i32 = torch.int32
    plan_p, plan_i = seg_plans if seg_plans is not None else (
        k2.seg_sum_plan(pose_ids, n_pose), k2.seg_sum_plan(intr_ids, n_intr))
    return SmatvecPlan(pose_ids=pose_ids.to(i32).contiguous(),
                       intr_ids=intr_ids.to(i32).contiguous(),
                       row_point=row_point.to(i32).contiguous(),
                       groups=groups.to(i32).contiguous(), plan_p=plan_p, plan_i=plan_i)


def smatvec(jp, ji, jx, pose_ids, intr_ids, vp, vi, hpp_inv, row_point, groups, plan=None):
    """(sp (P, 6), si (I, 8)) of the contract above.  `plan` (smatvec_plan
    of the same ids and tables) saves its construction on repeated calls."""
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
    P, I, L = vp.shape[0], vi.shape[0], hpp_inv.shape[0]
    f32 = (jp, ji, jx, vp, vi, hpp_inv)
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("the kernel takes float32 Jacobians, vectors and point blocks")
    if any(t.device != jp.device for t in f32 + (pose_ids, intr_ids, row_point, groups)):
        raise ValueError("every input must be on one device")
    shapes_ok = (jp.numel() == O * 12 and ji.numel() == O * 16 and jx.numel() == O * 6
                 and pose_ids.shape == (O,) and intr_ids.shape == (O,)
                 and vp.shape == (P, 6) and vi.shape == (I, 8) and hpp_inv.shape == (L, 3, 3)
                 and groups.dim() == 2 and groups.shape[0] == L and L >= 1)
    if not shapes_ok:
        raise ValueError("shapes do not match the contract (see the module note)")
    if O >= 2 ** 31 // 16:
        raise ValueError(f"{O} slots: slot offsets must fit int32")
    if plan is None:
        plan = smatvec_plan(pose_ids, intr_ids, row_point, groups, P, I)
    pp, pi = plan.plan_p, plan.plan_i
    if (pp.num != P or pi.num != I or pp.n_rows != O or pi.n_rows != O
            or plan.row_point.shape != (L1,) or plan.groups.shape != groups.shape):
        raise ValueError("the plan was built for other ids, tables or counts")
    jp, ji, jx = jp.contiguous(), ji.contiguous(), jx.contiguous()
    vp, vi, hpp_inv = vp.contiguous(), vi.contiguous(), hpp_inv.contiguous()
    ncp, nci = pp.chunk_start.shape[0], pi.chunk_start.shape[0]
    dev = jp.device
    row_sums = torch.empty((L1, 3), dtype=torch.float32, device=dev)
    y = torch.empty((L, 3), dtype=torch.float32, device=dev)
    part_p = torch.empty((max(ncp, 1), 6), dtype=torch.float32, device=dev)
    part_i = torch.empty((max(nci, 1), 8), dtype=torch.float32, device=dev)
    sp = torch.empty((P, 6), dtype=torch.float32, device=dev)
    si = torch.empty((I, 8), dtype=torch.float32, device=dev)
    lib = build()
    err = lib.omt_smatvec_f32(
        jp.data_ptr(), ji.data_ptr(), jx.data_ptr(), plan.pose_ids.data_ptr(),
        plan.intr_ids.data_ptr(), vp.data_ptr(), vi.data_ptr(), hpp_inv.data_ptr(),
        plan.row_point.data_ptr(), plan.groups.data_ptr(), pp.perm.data_ptr(),
        pp.chunk_start.data_ptr(), pp.chunk_end.data_ptr(), pp.seg_chunk_off.data_ptr(),
        pi.perm.data_ptr(), pi.chunk_start.data_ptr(), pi.chunk_end.data_ptr(),
        pi.seg_chunk_off.data_ptr(), L1, O // L1, L, groups.shape[1], P, I, ncp, nci,
        row_sums.data_ptr(), y.data_ptr(), part_p.data_ptr(), part_i.data_ptr(),
        sp.data_ptr(), si.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"smatvec kernel launch failed: cudaError {err}")
    LAUNCHES += 2 + int(ncp + nci > 0) + int(P * 6 + I * 8 > 0)
    return sp, si
