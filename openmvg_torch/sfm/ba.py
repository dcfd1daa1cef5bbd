"""Bundle adjustment: Levenberg-Marquardt with an implicit Schur-complement,
block-Jacobi preconditioned CG (counterpart: openmvg_tpu/sfm/ba.py; openMVG
sfm/sfm_data_BA_ceres.cpp Bundle_Adjustment_Ceres::Adjust).

Angle-axis + translation pose blocks, per-camera-model reprojection
residuals, Huber loss with a = 4^2, masks that hold parts of the
intrinsics, poses or structure constant, GPS pose-centre priors.  One
flat observation table (pose id, intrinsic id, point id, pixel): residuals
and the (O, 2, 6) pose, (O, 2, 8) intrinsic and (O, 2, 3) point Jacobian
blocks come from one batched call on one of three paths, chosen once a
solve from the intrinsic kinds (cam_fast_ok, one host read):

  JAC_PINHOLE  every intrinsic a plain PINHOLE: closed form (the
               reference's cam_fast)
  JAC_POLY     every intrinsic of kind 2, 3 or 4 (radial K1, radial K3,
               Brown T2, one additive distortion formula): closed form, in
               the problem's dtype (the reference has none)
  JAC_GENERIC  any fisheye or spherical intrinsic: torch.func forward
               mode over every camera kind, with float64 tangents
               (torch.func's promotion) cast back

The costs take the projection of the path that the Jacobians take.  The
Schur complement is never formed: CG runs on J-products, per-point 3x3
solves and segment sums.

  camera side  J^T u and J^T J over the pose and intrinsic slots go through
               kernel K2's fused camera sums (ops/seg_sum.py: camera_jtu,
               camera_jtj, one launch for both halves, the products formed
               in registers) on the card, with one plan per problem (the
               slot ids are fixed across the LM loop)
  point side   the point-major layout (build_pt_obs / point_major_layout):
               each point's observations are contiguous R-slot rows, so a
               point sum is a reshape-sum, the same order on every run

On the card, an unsharded float32 problem in the point-major layout runs
each CG iteration's matvec through kernel K3 (ops/smatvec.py) instead,
with K3's plan built once a problem beside K2's (with_plans) from the
rows' points alone; every other problem (the CPU, float64, the gather-form
tables, a sharded solve) takes the unfused sequence of J-products and K2
sums.  The reference keeps its fused matvec off unless
OMT_FUSED_SMATVEC=1; the port has no switch.

The Jacobian blocks are evaluated in one pass, or on the card, where the
memory the process can still take would not hold one pass of the path
that runs (JAC_BYTES_PER_SLOT a slot for the generic path,
JAC_CLOSED_BYTES_PER_SLOT for the closed forms), in chunks of whole rows
written into the blocks; each block depends on its own row alone, so the
chunked blocks are the one-pass blocks bit for bit.

Sharded solves (parallel/dist_ba.py) pass a process group: each rank
holds its rows of the observation table, forms its J-products and sums
on them, and the sums are all-reduced (the reference's psum over `axis`).
Observation-sharded, the parameters are whole on every rank and so are
the point sums, reduced like the camera sums; point-sharded
(shard_points), each rank owns a block of points and all their
observations, and only the camera sums, the cost and the point term of
the predicted gain are reduced.  The pose-prior terms are added once,
after the reduction.  Every branch (the CG stopping test, LM's accept, the
damping cap) reads values that every rank holds bit for bit alike, so the
ranks take the same branches.  K3 stays off when sharded, as the
reference gates it.

The LM loop and the CG loop are host loops; each reads its stopping test
from the device once per iteration.  The dtype is a parameter: the engine
runs float32 on the card, the tests float64.  Small dense inverses use
ops/linalg (no cuSOLVER).

While a profiler session records, each solve leaves spans and counters
(utils/logging): ba.adjust holds ba.plans, host_read and ba.lm_step; each
step holds ba.cost (both costs), ba.jacobians, ba.schur (the solve up to
the CG loop), ba.cg (the loop, a host_read for each stopping test) and
ba.backsub, all with device times on the card.  Every read of the device
goes through host_read.  The counters: ba.cg_iterations (the
iterations each CG loop ran), ba.cg_k3 (those of them whose matvec ran
in K3), ba.lm_accepted (the accepted steps), ba.jac_chunks (the
chunks the Jacobians took, one for a pass) and ba.jac_closed (those of
them that a closed form, pinhole or polynomial, computed).
"""

from typing import NamedTuple

import numpy as np
import torch

from openmvg_torch.geometry import so3
from openmvg_torch.models import cameras as cm
from openmvg_torch.ops import linalg
from openmvg_torch.ops import seg_sum as k2
from openmvg_torch.ops import smatvec as k3
from openmvg_torch.utils import hostmath
from openmvg_torch.utils.collectives import all_reduce
from openmvg_torch.utils.logging import count, host_read, span

# refine-option masks (Intrinsic_Parameter_Type / Extrinsic_Parameter_Type)
ADJUST_ALL = "ALL"
ADJUST_NONE = "NONE"

# The Jacobians' paths (cam_fast_ok); False and True name the first two.
JAC_GENERIC, JAC_PINHOLE, JAC_POLY = 0, 1, 2

# Peak device bytes a slot of one pass of jacobians through the generic
# forward-mode Jacobians (_generic_r_J: the gathers, vmap(jacfwd) with its
# float64 tangents, the weights and masks), its returned blocks included:
# torch.cuda.max_memory_allocated over one call, less what was allocated
# before it, over the slots: 3,886.35 B on an NVIDIA H100 80GB HBM3 at BAL
# Dubrovnik's float32 camera-model-3 layout (1,600,800 slots), rounded up.
# Fisheye, spherical and mixed problems take this path.
JAC_BYTES_PER_SLOT = 3887
# The same for the closed forms (_poly_r_J, the larger of the two), measured
# the same way at the same layout: 496.73 and 497.42 B in two processes on
# an NVIDIA H100 80GB HBM3, rounded up.  PINHOLE and the polynomial kinds
# 2-4 take these paths.
JAC_CLOSED_BYTES_PER_SLOT = 498


class PtObsTable(NamedTuple):
    """Point-side reduction tables (see build_pt_obs).

    rows None is the point-major layout: the observation table is laid out
    in (L1, R) row-major blocks, row r owning obs slots [r R, (r + 1) R),
    all of point row_point[r]; slack slots have obs_w = 0.  Otherwise rows
    (L1, R) holds obs row ids padded with O (gather form).  groups (L, M)
    folds rows back to points (padded with L1), or is None, and then a
    segment sum over row_point does it."""

    rows: torch.Tensor       # (L1, R) int64, or None => point-major layout
    row_point: torch.Tensor  # (L1,) int64
    groups: torch.Tensor     # (L, M) int64 or None


class BAProblem(NamedTuple):
    """Device-side BA problem; ids are dense, padding via obs_w = 0."""

    obs_pose: torch.Tensor   # (O,)
    obs_intr: torch.Tensor   # (O,)
    obs_point: torch.Tensor  # (O,)
    obs_x: torch.Tensor      # (O, 2)
    obs_w: torch.Tensor      # (O,) 0/1 (or confidence)
    rotvec: torch.Tensor     # (P, 3) axis-angle of world->cam R
    t: torch.Tensor          # (P, 3) translation (x_c = R X + t)
    intr_kind: torch.Tensor  # (I,)
    intr_wh: torch.Tensor    # (I, 2)
    intr_params: torch.Tensor  # (I, 8)
    X: torch.Tensor          # (L, 3)
    mask_pose: torch.Tensor  # (P, 6) 1 = free
    mask_intr: torch.Tensor  # (I, 8)
    mask_X: torch.Tensor     # (L,) 1 = free
    prior_C: torch.Tensor    # (P, 3) GPS pose-centre priors
    prior_w: torch.Tensor    # (P, 3) per-axis prior weights (0 = none)
    pt_obs: PtObsTable = None
    # K2 plans for obs_pose and obs_intr (with_plans); None on the CPU
    seg_plans: tuple = None
    # K2 plan for obs_point when pt_obs is None, or for pt_obs.row_point when
    # it has no group table (with_plans)
    point_plan: object = None
    # K3 plan (ops/smatvec.py) when k3_gate holds, built with seg_plans
    k3_plan: object = None
    # slots of one chunk of jacobians (with_plans, on the card), whole rows
    # of the point-major layout; None: one pass
    jac_slots: int = None


class BAConfig(NamedTuple):
    huber_a: float = 16.0      # ceres HuberLoss(Square(4.0))
    max_iterations: int = 50
    cg_iterations: int = 60
    cg_tol: float = 1e-2       # relative CG residual (inexact Newton)
    lam_init: float = 1e-4
    lam_up: float = 4.0
    lam_down: float = 0.5
    use_huber: bool = True
    function_tolerance: float = 1e-6  # ceres Solver::Options default


# ---------------------------------------------------------------------------
# residuals / jacobians
# ---------------------------------------------------------------------------

def _residual_one(pose6, intr8, X, kind, wh, x_obs):
    """Reprojection residual (..., 2), pure in all parameters; broadcasts
    over rows."""
    Xc = so3.rotate(pose6[..., :3], X) + pose6[..., 3:]
    return cm.residual(kind, intr8, wh[..., 0], wh[..., 1], Xc, x_obs)


def _prior_residual_one(pose6, prior_C, prior_w):
    """GPS pose-centre residual sqrt(w) (C - prior), C = -R^T t = -rotate(-w, t)
    (PoseCenterConstraintCostFunction, sfm_data_BA_ceres.cpp:453-473)."""
    C = -so3.rotate(-pose6[..., :3], pose6[..., 3:])
    return torch.sqrt(torch.clamp(prior_w, min=0.0)) * (C - prior_C)


def _intr_rows(a, p):
    """Per-obs rows of an intrinsic table; one shared row is broadcast.
    (index_select: indexing gathers (O, 8) rows many times slower on the
    card.)"""
    O = p.obs_pose.shape[0]
    if a.shape[0] == 1:
        return a[0].expand((O,) + a.shape[1:])
    return torch.index_select(a, 0, p.obs_intr)


def _gather_params(p: BAProblem):
    pose6 = torch.cat([p.rotvec, p.t], -1)
    return (pose6[p.obs_pose], _intr_rows(p.intr_params, p), _pt_expand(p.X, p),
            _intr_rows(p.intr_kind, p), _intr_rows(p.intr_wh, p))


def residuals(p: BAProblem, cam_fast=JAC_GENERIC):
    """Reprojection residuals (O, 2) through the projection of the path
    `cam_fast` (cam_fast_ok)."""
    if cam_fast == JAC_PINHOLE:
        return _fast_pinhole_project(p)[0]
    if cam_fast == JAC_POLY:
        return _poly_project(p)[0]
    g = _gather_params(p)
    return _residual_one(*g, p.obs_x)


def _fast_pinhole_project(p: BAProblem):
    pose6 = torch.cat([p.rotvec, p.t], -1)[p.obs_pose]
    intr = _intr_rows(p.intr_params, p)
    X = _pt_expand(p.X, p)
    w, t = pose6[:, :3], pose6[:, 3:]
    Xc = so3.rotate(w, X) + t
    zs = cm.clamp_depth(Xc[..., 2])
    px = Xc[..., 0] / zs
    py = Xc[..., 1] / zs
    f = intr[:, 0]
    r = torch.stack([f * px + intr[:, 1] - p.obs_x[:, 0],
                     f * py + intr[:, 2] - p.obs_x[:, 1]], -1)
    return r, w, X, zs, px, py, f


def _rodrigues_bc(w):
    """The coefficients b, c of Jr(w) = I - b [w]_x + c [w]_x^2, with their
    small-angle series."""
    th2 = (w * w).sum(-1)
    small = th2 < 1e-8
    th = torch.sqrt(torch.clamp(th2, min=1e-16))
    b = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(th)) / torch.clamp(th2, min=1e-16))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / torch.clamp(th2 * th, min=1e-24))
    return b, c


def _fast_pinhole_r_J(p: BAProblem):
    """Residuals and the (O,2,6) / (O,2,8) / (O,2,3) Jacobian blocks in
    closed form, for problems whose every intrinsic is a plain PINHOLE."""
    r, w, X, zs, px, py, f = _fast_pinhole_project(p)
    invz = 1.0 / zs
    z3 = torch.zeros_like(invz)
    A0 = torch.stack([f * invz, z3, -f * px * invz], -1)   # d r / d Xc
    A1 = torch.stack([z3, f * invz, -f * py * invz], -1)
    JX0 = so3.rotate(-w, A0)                               # rows of A R
    JX1 = so3.rotate(-w, A1)
    Jx3 = torch.stack([JX0, JX1], -2)
    b, c = _rodrigues_bc(w)

    def row_jw(JXk):
        # d r / d w = -(A R) [X]_x Jr(w), row form via cross products
        u = torch.cross(JXk, X, dim=-1)
        uw = torch.cross(u, w, dim=-1)
        return -(u - b[:, None] * uw + c[:, None] * torch.cross(uw, w, dim=-1))

    Jp6 = torch.cat([torch.stack([row_jw(JX0), row_jw(JX1)], -2),
                     torch.stack([A0, A1], -2)], -1)
    O = r.shape[0]
    zc = torch.zeros(O, dtype=r.dtype, device=r.device)
    oc = torch.ones(O, dtype=r.dtype, device=r.device)
    Ji8 = torch.cat([torch.stack([torch.stack([px, oc, zc], -1),
                                  torch.stack([py, zc, oc], -1)], -2),
                     torch.zeros((O, 2, p.intr_params.shape[1] - 3), dtype=r.dtype,
                                 device=r.device)], -1)
    return r, Jp6, Ji8, Jx3


def _slot_cols(table, ids):
    """The columns of a per-pose or per-intrinsic table (N, k) at each
    slot, (k, O) with each column contiguous; (k, 1) for one shared row."""
    if table.shape[0] == 1:
        return table.T
    return torch.index_select(table.T.contiguous(), 1, ids)


def _interleave(cols):
    """k (O,) columns as one contiguous (O, k) block: a transposed copy of
    their stack, on the card about ten times faster than torch.stack on
    the last axis."""
    return torch.stack(cols, 0).T.contiguous()


def _poly_project(p: BAProblem):
    """The projection of the polynomial kinds 2-4 on one (O,) tensor a
    component: Xc = R X + t with R (row-major) and t gathered from the
    poses, p = (x, y) / z, then cameras.add_disto's additive Brown T2 term
    (k1, k2, k3, t1, t2 = params[3:8]; radial K1 and K3 hold the unused
    ones at 0), then f p_d + (ppx, ppy).  Returns r (O, 2) and what the
    Jacobians reuse."""
    g = _slot_cols(torch.cat([so3.expmap(p.rotvec).reshape(-1, 9), p.t], 1), p.obs_pose)
    X = _pt_expand(p.X, p).T.contiguous()
    Xc = [g[3 * i] * X[0] + g[3 * i + 1] * X[1] + g[3 * i + 2] * X[2] + g[9 + i]
          for i in range(3)]
    z = Xc[2]
    zs = cm.clamp_depth(z)
    x = Xc[0] / zs
    y = Xc[1] / zs
    ic = _slot_cols(p.intr_params, p.obs_intr)
    f, ppx, ppy, k1, k2, k3, t1, t2 = ic
    r2 = x * x + y * y
    k_diff = k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x + (x * k_diff + (t2 * (r2 + 2 * x * x) + 2 * t1 * x * y))
    yd = y + (y * k_diff + (t1 * (r2 + 2 * y * y) + 2 * t2 * x * y))
    r = _interleave([f * xd + ppx - p.obs_x[:, 0], f * yd + ppy - p.obs_x[:, 1]])
    return r, (g[:9], X, z, zs, x, y, r2, k_diff, xd, yd, ic)


def _poly_r_J(p: BAProblem):
    """Residuals and the (O,2,6) / (O,2,8) / (O,2,3) Jacobian blocks in
    closed form, in the problem's dtype, for problems whose every intrinsic
    is of kind 2, 3 or 4, one (O,) tensor a component.  d r / d Xc = A =
    f D dp/dXc, D = dp_d/dp the distortion's symmetric 2x2 derivative, with
    dp/dXc's z column zero where clamp_depth clamped the depth (as the
    generic path's torch.where gives); the point rows A R; the pose rows
    -(A R) [X]_x Jr(w) through the small-angle/Rodrigues coefficients b, c
    of _fast_pinhole_r_J's row_jw, -(I + b [w]_x + c [w]_x^2) formed once a
    pose; and all eight intrinsic columns (the masks hold the unused
    ones)."""
    r, (R, X, z, zs, x, y, r2, k_diff, xd, yd, ic) = _poly_project(p)
    f, _, _, k1, k2, k3, t1, t2 = ic
    dk = 2.0 * (k1 + 2.0 * k2 * r2 + 3.0 * k3 * r2 * r2)   # d k_diff / d x = dk x
    d00 = 1.0 + k_diff + dk * x * x + 6.0 * t2 * x + 2.0 * t1 * y
    d11 = 1.0 + k_diff + dk * y * y + 6.0 * t1 * y + 2.0 * t2 * x
    d01 = dk * x * y + 2.0 * (t1 * x + t2 * y)
    fz = f / zs
    dz = torch.where(zs == z, -fz, torch.zeros_like(fz))   # 0 where clamped
    a01 = fz * d01
    A = ((fz * d00, a01, dz * (d00 * x + d01 * y)),
         (a01, fz * d11, dz * (d01 * x + d11 * y)))
    w = p.rotvec
    b, c = _rodrigues_bc(w)
    K = so3.skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    M = _slot_cols(-(eye + b[:, None, None] * K + c[:, None, None] * (K @ K)).reshape(-1, 9),
                   p.obs_pose)
    Jp, Jx = [], []
    for Ak in A:
        JX = [Ak[0] * R[j] + Ak[1] * R[3 + j] + Ak[2] * R[6 + j] for j in range(3)]
        u = (JX[1] * X[2] - JX[2] * X[1], JX[2] * X[0] - JX[0] * X[2],
             JX[0] * X[1] - JX[1] * X[0])                 # (A R) x X
        Jp += [M[3 * i] * u[0] + M[3 * i + 1] * u[1] + M[3 * i + 2] * u[2]
               for i in range(3)] + list(Ak)
        Jx += JX
    O = x.shape[0]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    fr2 = f * r2
    fxy2 = 2.0 * f * x * y
    Ji = [xd, one, zero, fr2 * x, fr2 * r2 * x, fr2 * r2 * r2 * x, fxy2, f * (r2 + 2 * x * x),
          yd, zero, one, fr2 * y, fr2 * r2 * y, fr2 * r2 * r2 * y, f * (r2 + 2 * y * y), fxy2]
    return (r, _interleave(Jp).reshape(O, 2, 6), _interleave(Ji).reshape(O, 2, 8),
            _interleave(Jx).reshape(O, 2, 3))


def _generic_r_J(p: BAProblem):
    """Forward-mode Jacobians of _residual_one over every camera kind.
    (torch.func promotes a float32 tangent through a 0-dim tensor and a
    Python float to float64, so the blocks are cast back.)"""
    from torch.func import jacfwd, vmap

    g = _gather_params(p)
    J = vmap(jacfwd(_residual_one, argnums=(0, 1, 2)))(*g, p.obs_x)
    return (_residual_one(*g, p.obs_x),) + tuple(j.to(p.X.dtype) for j in J)


def _huber_sqrt_weight(r, a, use_huber):
    """sqrt of the IRLS weight of ceres HuberLoss(a): rho(s) = s for s <= a,
    2 sqrt(a s) - a beyond; weight rho'(s) = 1 or sqrt(a / s)."""
    if not use_huber:
        return torch.ones_like(r[..., 0])
    s = (r * r).sum(-1)
    w = torch.where(s <= a, torch.ones_like(s), torch.sqrt(a / torch.clamp(s, min=1e-30)))
    return torch.sqrt(w)


def _reduce(group, *ts):
    """The sums of `ts` over the ranks of `group` (one all-reduce for all
    of them); the tensors themselves when group is None."""
    if group is None:
        return ts if len(ts) > 1 else ts[0]
    flat = all_reduce(torch.cat([t.reshape(-1) for t in ts]), group)
    out = tuple(a.reshape(t.shape) for a, t in zip(flat.split([t.numel() for t in ts]), ts))
    return out if len(out) > 1 else out[0]


def robust_cost(p: BAProblem, cfg: BAConfig, cam_fast=JAC_GENERIC, group=None):
    """0.5 * sum rho(|r|^2) over weighted observations, plus the priors
    (added once, after the sum over the ranks of `group`)."""
    r = residuals(p, cam_fast)
    s = (r * r).sum(-1)
    if cfg.use_huber:
        a = cfg.huber_a
        rho = torch.where(s <= a, s, 2.0 * torch.sqrt(a * torch.clamp(s, min=0.0)) - a)
    else:
        rho = s
    c = _reduce(group, 0.5 * (rho * p.obs_w).sum())
    rp = _prior_residual_one(torch.cat([p.rotvec, p.t], -1), p.prior_C, p.prior_w)
    return c + 0.5 * (rp * rp).sum()


def _weighted_r_J(p: BAProblem, cfg: BAConfig, cam_fast):
    r, Jp6, Ji8, Jx3 = (_generic_r_J, _fast_pinhole_r_J, _poly_r_J)[cam_fast](p)
    w = _huber_sqrt_weight(r, cfg.huber_a, cfg.use_huber) * p.obs_w
    r = r * w[:, None]
    Jp6 = Jp6 * w[:, None, None] * p.mask_pose[p.obs_pose][:, None, :]
    Ji8 = Ji8 * w[:, None, None] * _intr_rows(p.mask_intr, p)[:, None, :]
    Jx3 = Jx3 * w[:, None, None] * _pt_expand(p.mask_X[:, None], p)[:, None, :]
    return r, Jp6, Ji8, Jx3


def _obs_range(p: BAProblem, s0, s1):
    """p restricted to the observation slots [s0, s1): whole rows of the
    point-major layout, any slots of the other forms."""
    t = p.pt_obs
    if t is not None and t.rows is None:
        R = p.obs_pose.shape[0] // t.row_point.shape[0]
        t = PtObsTable(rows=None, row_point=t.row_point[s0 // R:s1 // R], groups=None)
    else:
        t = None   # _pt_expand then gathers through obs_point
    return p._replace(pt_obs=t, **{f: getattr(p, f)[s0:s1] for f in
                                   ("obs_pose", "obs_intr", "obs_point", "obs_x", "obs_w")})


def jacobians(p: BAProblem, cfg: BAConfig, cam_fast=JAC_GENERIC):
    """Weighted residuals and Jacobian blocks with the masks applied, on the
    path `cam_fast` (cam_fast_ok): in one pass, or in chunks of p.jac_slots
    slots written into the blocks."""
    O, step = p.obs_pose.shape[0], p.jac_slots
    closed = cam_fast != JAC_GENERIC
    if step is None or step >= O:
        count("ba.jac_chunks", 1)
        count("ba.jac_closed", int(closed))
        return _weighted_r_J(p, cfg, cam_fast)
    out = None
    for s0 in range(0, O, step):
        s1 = min(s0 + step, O)
        blocks = _weighted_r_J(_obs_range(p, s0, s1), cfg, cam_fast)
        if out is None:   # the one-pass blocks' strides (jacfwd leaves them transposed)
            out = [torch.empty_strided((O,) + b.shape[1:], b.stride(), dtype=b.dtype,
                                       device=b.device) for b in blocks]
        for o, b in zip(out, blocks):
            o[s0:s1] = b
        del blocks
    count("ba.jac_chunks", -(-O // step))
    count("ba.jac_closed", -(-O // step) if closed else 0)
    return tuple(out)


def jac_chunk_slots(p: BAProblem, cam_fast=JAC_GENERIC):
    """Slots of one chunk of jacobians on the path `cam_fast` on the card:
    half of what the process can still allocate (the card's free memory
    and the allocator's unused cache), less the blocks jacobians returns,
    over the path's bytes a slot (JAC_BYTES_PER_SLOT, or
    JAC_CLOSED_BYTES_PER_SLOT for a closed form), in whole rows of the
    point-major layout; None where one pass fits."""
    dev = p.X.device
    free = (torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev)
            - torch.cuda.memory_allocated(dev))
    O = p.obs_pose.shape[0]
    per_slot = JAC_BYTES_PER_SLOT if cam_fast == JAC_GENERIC else JAC_CLOSED_BYTES_PER_SLOT
    slots = (free - O * 36 * p.X.element_size()) // 2 // per_slot
    if slots >= O:
        return None
    t = p.pt_obs
    R = O // t.row_point.shape[0] if t is not None and t.rows is None else 1
    return max(R, slots // R * R)


# ---------------------------------------------------------------------------
# segment sums
# ---------------------------------------------------------------------------

def _seg_sum(vals, ids, num, plan=None):
    """Segment sum over the first axis: kernel K2 on the card, its plain
    version on the CPU; either way one fixed order of additions."""
    O = vals.shape[0]
    return k2.seg_sum(vals.reshape(O, -1), ids, num, plan).reshape((num,) + vals.shape[1:])


def k3_gate(p: BAProblem, group=None):
    """Whether the CG matvec of `p` runs through kernel K3: an unsharded
    float32 problem on the card, in the point-major layout, with or without
    a group table (on the CPU, K3's plain version is no faster than the
    unfused matvec)."""
    t = p.pt_obs
    if (group is not None or not p.X.is_cuda or p.X.dtype != torch.float32
            or t is None or t.rows is not None):
        return False
    L1 = t.row_point.shape[0]
    return L1 > 0 and p.obs_pose.shape[0] % L1 == 0


def with_plans(p: BAProblem, group=None, cam_fast=JAC_GENERIC):
    """The problem with K2 plans for its pose and intrinsic ids, for its
    point ids when it has no point tables, or for its rows' points when it
    has no group table, K3's plan, reusing K2's, when k3_gate holds, and
    the Jacobians' chunk on the path `cam_fast` (jac_chunk_slots; the
    generic path's, the largest, where the caller names none): all built
    once per problem on the card, whenever seg_plans is None, so a problem
    whose seg_plans were cleared gets them all anew.  The plain CPU path
    needs none."""
    if p.obs_pose.device.type != "cuda" or p.seg_plans is not None:
        return p
    seg_plans = (k2.seg_sum_plan(p.obs_pose, p.rotvec.shape[0]),
                 k2.seg_sum_plan(p.obs_intr, p.intr_params.shape[0]))
    t, n_pts = p.pt_obs, p.X.shape[0]
    return p._replace(
        seg_plans=seg_plans,
        point_plan=(k2.seg_sum_plan(p.obs_point, n_pts) if t is None else
                    k2.seg_sum_plan(t.row_point, n_pts) if t.groups is None else None),
        k3_plan=(k3.smatvec_plan(p.obs_pose, p.obs_intr, t.row_point, n_pts,
                                 p.rotvec.shape[0], p.intr_params.shape[0], seg_plans)
                 if k3_gate(p, group) else None),
        jac_slots=jac_chunk_slots(p, cam_fast))


def build_pt_obs(obs_point, obs_w, n_points, group_budget_elems=1 << 24):
    """Host-side two-level tables (PtObsTable, gather form) for point-block
    sums.  Row width R is chosen among 4..32 to minimise slots plus three
    slot-equivalents per row, bounded by the 99th-percentile track length;
    points with more observations span several rows.  Rows with obs_w == 0
    are left out."""
    obs_point = np.asarray(obs_point)
    O = len(obs_point)
    n_points = max(n_points, 1)
    sel = np.nonzero(np.asarray(obs_w) != 0)[0]
    if len(sel) == 0:
        rows = np.full((n_points, 2), O, np.int64)
        groups = np.arange(n_points, dtype=np.int64)[:, None]
        return PtObsTable(rows=rows, row_point=groups[:, 0], groups=groups)
    ids = obs_point[sel]
    counts = np.bincount(ids, minlength=n_points)
    nz = counts[counts > 0]
    p99 = int(np.percentile(nz, 99))
    r_hi = 1 << max(2, (max(p99, 1) - 1).bit_length())
    r_hi = min(r_hi, 1 << (int(counts.max()) - 1).bit_length())
    R, best = r_hi, None
    for cand in (4, 8, 16, 32):
        if cand > r_hi:
            break
        rows_c = int(np.sum(-(-counts // cand)) + np.sum(counts == 0))
        cost = rows_c * cand + 3 * rows_c
        if best is None or cost < best:
            R, best = cand, cost
    nrow = np.maximum((counts + R - 1) // R, 1)  # every point owns >= 1 row
    M = int(nrow.max())
    L1 = int(nrow.sum())
    row_start = np.zeros(n_points + 1, np.int64)
    np.cumsum(nrow, out=row_start[1:])
    order = np.argsort(ids, kind="stable")
    starts = np.zeros(n_points + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(len(sel)) - starts[ids[order]]
    rows = np.full((L1, R), O, np.int64)
    rows[row_start[ids[order]] + rank // R, rank % R] = sel[order]
    row_point = np.repeat(np.arange(n_points, dtype=np.int64), nrow)
    Mp = 1 << max(0, (M - 1).bit_length())
    if n_points * Mp <= group_budget_elems:
        col = np.arange(Mp, dtype=np.int64)[None, :]
        groups = np.where(col < nrow[:, None], row_start[:n_points, None] + col, L1)
    else:
        groups = None
    return PtObsTable(rows=rows, row_point=row_point, groups=groups)


def point_major_layout(obs_pose, obs_intr, obs_point, obs_x, obs_w, n_points):
    """Host-side: reorder the observation table into the point-major
    layout, with no rows beyond those the points need (the slack slots of
    each row get obs_w = 0).  Returns the relaid (obs_pose, obs_intr,
    obs_point, obs_x, obs_w, PtObsTable)."""
    t = build_pt_obs(obs_point, obs_w, n_points)
    perm = t.rows.reshape(-1)

    def lay(a):
        a = np.asarray(a)
        return np.concatenate([a, np.zeros((1,) + a.shape[1:], a.dtype)])[perm]

    table = PtObsTable(rows=None, row_point=t.row_point, groups=t.groups)
    return (lay(obs_pose), lay(obs_intr), lay(obs_point), lay(obs_x), lay(obs_w), table)


def _pt_seg_sum(vals, p: BAProblem, num):
    """Point-block segment sum: a reshape-sum in the point-major layout or
    a gather and dense sum with a gather table, then the rows folded into
    points through the group table, or through K2 where the group table
    was over its budget."""
    t = p.pt_obs
    if t is None:
        return _seg_sum(vals, p.obs_point, num, p.point_plan)
    if t.rows is None:
        L1 = t.row_point.shape[0]
        R = vals.shape[0] // L1
        row_sums = vals.reshape((L1, R) + vals.shape[1:]).sum(1)
    else:
        padded = torch.cat([vals, vals.new_zeros((1,) + vals.shape[1:])], 0)
        row_sums = padded[t.rows].sum(1)
    if row_sums.shape[0] == num and t.groups is not None and t.groups.shape[1] == 1:
        return row_sums  # one row per point: level 2 is the identity
    if t.groups is None:
        return _seg_sum(row_sums, t.row_point, num, p.point_plan)
    rs = torch.cat([row_sums, row_sums.new_zeros((1,) + row_sums.shape[1:])], 0)
    return rs[t.groups].sum(1)


def _pt_expand(y, p: BAProblem):
    """Per-point rows (L, k) -> per-obs rows (O, k); point-major problems
    broadcast one gathered row over each row's R slots."""
    t = p.pt_obs
    if t is not None and t.rows is None:
        O = p.obs_point.shape[0]
        L1 = t.row_point.shape[0]
        R = O // L1
        yr = y[torch.clamp(t.row_point, max=y.shape[0] - 1)]
        return yr[:, None].expand((L1, R) + y.shape[1:]).reshape((O,) + y.shape[1:])
    return y[p.obs_point]


_outer_flat = k2.outer_flat
_brmatvec = k2.brmatvec


def _block_outer_pt(J, p: BAProblem, num):
    k = J.shape[-1]
    return _pt_seg_sum(_outer_flat(J), p, num).reshape(num, k, k)


def _bmatvec(J, v):
    """(O, 2, k) x (O, k) -> (O, 2)."""
    return (J * v[:, None, :]).sum(-1)


def _camera_matvec(vc_pose, vc_intr, p, Jp6, Ji8):
    """u_o = Jc_o v for the camera half: (O, 2)."""
    return _bmatvec(Jp6, vc_pose[p.obs_pose]) + _bmatvec(Ji8, _intr_rows(vc_intr, p))


def _camera_rmatvec(u, p, Jp6, Ji8, n_pose, n_intr):
    """Jc^T u reduced into (P, 6) and (I, 8): one K2 launch on the card,
    the plain products and segment sums on the CPU."""
    return k2.camera_jtu(Jp6, Ji8, u, p.obs_pose, p.obs_intr, n_pose, n_intr, p.seg_plans)


def _camera_jtj(p, Jp6, Ji8, n_pose, n_intr):
    """The J_o^T J_o blocks summed into (P, 6, 6) and (I, 8, 8): one K2
    launch on the card."""
    return k2.camera_jtj(Jp6, Ji8, p.obs_pose, p.obs_intr, n_pose, n_intr, p.seg_plans)


def _prior_blocks(p):
    """Per-pose prior Jacobian (P, 3, 6) and residual (P, 3)."""
    from torch.func import jacfwd, vmap

    pose6 = torch.cat([p.rotvec, p.t], -1)
    J = vmap(jacfwd(_prior_residual_one))(pose6, p.prior_C, p.prior_w).to(pose6.dtype)
    return J * p.mask_pose[:, None, :], _prior_residual_one(pose6, p.prior_C, p.prior_w)


def schur_cg_solve(p: BAProblem, r, Jp6, Ji8, Jx3, lam, cfg: BAConfig, group=None,
                   shard_points=False):
    """One damped normal-equation solve.  Returns (d_pose (P, 6), d_intr
    (I, 8), d_X (L, 3), predicted gain).  With `group`, the camera sums are
    all-reduced over its ranks, and the point sums too unless
    shard_points (then the points are this rank's own)."""
    pgroup = None if shard_points else group
    n_pose = p.rotvec.shape[0]
    n_intr = p.intr_params.shape[0]
    n_pts = p.X.shape[0]
    dt, dev = p.X.dtype, p.X.device
    on_card = p.X.is_cuda

    with span("ba.schur", device=on_card):
        eye3 = torch.eye(3, dtype=dt, device=dev)
        # point blocks Hpp = sum Jx^T Jx + lam diag; fixed/padded points get
        # an identity block (zero rhs -> zero update)
        Hpp = _reduce(pgroup, _block_outer_pt(Jx3, p, n_pts))
        dpp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
        Hpp = Hpp + lam * torch.clamp(dpp, min=1e-12)[..., None] * eye3
        Hpp = Hpp + ((1.0 - p.mask_X) + 1e-12)[:, None, None] * eye3

        gp, gi = _reduce(group, *_camera_rmatvec(-r, p, Jp6, Ji8, n_pose, n_intr))
        gx = _reduce(pgroup, _pt_seg_sum(_brmatvec(Jx3, -r), p, n_pts))

        Jprior, rprior = _prior_blocks(p)
        Hprior = torch.einsum("pij,pik->pjk", Jprior, Jprior)
        gprior = -torch.einsum("pij,pi->pj", Jprior, rprior)

        Hcc_p, Hcc_i = _reduce(group, *_camera_jtj(p, Jp6, Ji8, n_pose, n_intr))
        Hcc_p = Hcc_p + Hprior
        dcc_p = torch.clamp(torch.diagonal(Hcc_p, dim1=-2, dim2=-1), min=1e-12)
        dcc_i = torch.clamp(torch.diagonal(Hcc_i, dim1=-2, dim2=-1), min=1e-12)

        # formed once per solve: every apply of Hpp^-1 is one batched product
        Hpp_inv = linalg.inv_sym3(Hpp)

        def Hpp_solve(v):
            return torch.einsum("lij,lj->li", Hpp_inv, v)

        # reduced rhs b = gc - E Hpp^-1 gx, E v = Jc^T (Jx v)
        z = _bmatvec(Jx3, _pt_expand(Hpp_solve(gx), p))
        bp, bi = _reduce(group, *_camera_rmatvec(z, p, Jp6, Ji8, n_pose, n_intr))
        bp = gp + gprior - bp
        bi = gi - bi

        # fixed parameters: zero J columns, unit diagonal (solves stay regular,
        # updates stay zero)
        eye6 = torch.eye(6, dtype=dt, device=dev)
        eye8 = torch.eye(8, dtype=dt, device=dev)
        fp, fi = p.mask_pose, p.mask_intr
        Mp = Hcc_p + lam * dcc_p[..., None] * eye6
        Mi = Hcc_i + lam * dcc_i[..., None] * eye8
        Mp = Mp * (fp[:, :, None] * fp[:, None, :]) + eye6 * (1.0 - fp)[:, :, None]
        Mi = Mi * (fi[:, :, None] * fi[:, None, :]) + eye8 * (1.0 - fi)[:, :, None]
        Mp_inv = linalg.inv(Mp)
        Mi_inv = linalg.inv(Mi)

        # K3's plan, which with_plans built where k3_gate holds
        fused = p.k3_plan if group is None else None

        def S_matvec(vp, vi):
            """S v = (B + lam D) v - E Hpp^-1 E^T v, all implicit via J."""
            if fused is not None:
                sp, si = k3.smatvec(Jp6, Ji8, Jx3, p.obs_pose, p.obs_intr, vp, vi, Hpp_inv,
                                    p.pt_obs.row_point, p.pt_obs.groups, fused)
            else:
                u = _camera_matvec(vp, vi, p, Jp6, Ji8)
                y = Hpp_solve(_reduce(pgroup, _pt_seg_sum(_brmatvec(Jx3, u), p, n_pts)))
                sp, si = _reduce(group, *_camera_rmatvec(u - _bmatvec(Jx3, _pt_expand(y, p)), p,
                                                         Jp6, Ji8, n_pose, n_intr))
            sp = sp + torch.einsum("pij,pj->pi", Hprior, vp) + lam * dcc_p * vp
            si = si + lam * dcc_i * vi
            return sp, si

        def M_inv(vp, vi):
            return (torch.einsum("pij,pj->pi", Mp_inv, vp),
                    torch.einsum("pij,pj->pi", Mi_inv, vi))

        def dot(a, c):
            return (a[0] * c[0]).sum() + (a[1] * c[1]).sum()

        # PCG on the reduced camera system, stopped at ||r|| <= cg_tol ||b||
        b = (bp, bi)
        x = (torch.zeros_like(bp), torch.zeros_like(bi))
        rr = b
        zz = M_inv(*rr)
        pp = zz
        rz = dot(rr, zz)
        tol2 = cfg.cg_tol ** 2 * dot(b, b)

    with span("ba.cg", device=on_card):
        n_it = 0
        for _ in range(cfg.cg_iterations):
            if not host_read(dot(rr, rr) > tol2):
                break
            n_it += 1
            Ap = S_matvec(*pp)
            denom = dot(pp, Ap)
            alpha = rz / torch.where(denom.abs() < 1e-30, torch.full_like(denom, 1e-30), denom)
            x = (x[0] + alpha * pp[0], x[1] + alpha * pp[1])
            rr = (rr[0] - alpha * Ap[0], rr[1] - alpha * Ap[1])
            zz = M_inv(*rr)
            rz_new = dot(rr, zz)
            beta = rz_new / torch.where(rz.abs() < 1e-30, torch.full_like(rz, 1e-30), rz)
            pp = (zz[0] + beta * pp[0], zz[1] + beta * pp[1])
            rz = rz_new
        count("ba.cg_iterations", n_it)
        count("ba.cg_k3", n_it if fused is not None else 0)

    with span("ba.backsub", device=on_card):
        d_pose = x[0] * p.mask_pose
        d_intr = x[1] * p.mask_intr

        # back-substitute points: d_X = Hpp^-1 (gx - E^T dc)
        u = _camera_matvec(d_pose, d_intr, p, Jp6, Ji8)
        w = _reduce(pgroup, _pt_seg_sum(_brmatvec(Jx3, u), p, n_pts))
        d_X = Hpp_solve(gx - w) * p.mask_X[:, None]

        # predicted gain 0.5 d^T (lam D d + g); shard-local points' term summed
        gain_x = (d_X * (lam * torch.clamp(dpp, min=1e-12) * d_X + gx)).sum()
        if shard_points:
            gain_x = _reduce(group, gain_x)
        gain = 0.5 * ((d_pose * (lam * dcc_p * d_pose + gp)).sum()
                      + (d_intr * (lam * dcc_i * d_intr + gi)).sum()
                      + gain_x)
    return d_pose, d_intr, d_X, gain


def _apply_step(p: BAProblem, d_pose, d_intr, d_X):
    return p._replace(rotvec=p.rotvec + d_pose[:, :3], t=p.t + d_pose[:, 3:],
                      intr_params=p.intr_params + d_intr, X=p.X + d_X)


def cam_fast_ok(p: BAProblem):
    """The Jacobians' path for p's intrinsic kinds, in one host read:
    JAC_PINHOLE where every row is a plain PINHOLE, JAC_POLY where every
    row is of kind 2, 3 or 4, JAC_GENERIC otherwise (a fisheye or
    spherical row, or no row)."""
    kinds = p.intr_kind
    if kinds.numel() == 0:
        return JAC_GENERIC
    poly = ((kinds == cm.PINHOLE_RADIAL_K1) | (kinds == cm.PINHOLE_RADIAL_K3)
            | (kinds == cm.PINHOLE_BROWN)).all()
    return host_read((kinds == cm.PINHOLE).all() * JAC_PINHOLE + poly * JAC_POLY)


def lm_step(p: BAProblem, lam, cfg: BAConfig, cam_fast=None, group=None,
            shard_points=False):
    """One LM iteration: solve, tentative step, accept/reject, adapt lam.
    Returns (problem, lam, cost, accepted) with tensor lam/cost/accepted.
    `group` and `shard_points`: the sharded modes of schur_cg_solve; the
    costs are summed over the ranks, so every rank accepts alike."""
    on_card = p.X.is_cuda
    with span("ba.lm_step", device=on_card):
        if cam_fast is None:
            cam_fast = cam_fast_ok(p)
        p = with_plans(p, group, cam_fast)
        lam = torch.as_tensor(lam, dtype=p.X.dtype, device=p.X.device)
        with span("ba.cost", device=on_card):
            cost0 = robust_cost(p, cfg, cam_fast, group)
        with span("ba.jacobians", device=on_card):
            r, Jp6, Ji8, Jx3 = jacobians(p, cfg, cam_fast)
        d_pose, d_intr, d_X, _ = schur_cg_solve(p, r, Jp6, Ji8, Jx3, lam, cfg, group,
                                                shard_points)
        p_new = _apply_step(p, d_pose, d_intr, d_X)
        with span("ba.cost", device=on_card):
            cost1 = robust_cost(p_new, cfg, cam_fast, group)
        accept = cost1 < cost0
        sel = {f: torch.where(accept, getattr(p_new, f), getattr(p, f))
               for f in ("rotvec", "t", "intr_params", "X")}
        lam_new = torch.where(accept, lam * cfg.lam_down, lam * cfg.lam_up)
        return p._replace(**sel), lam_new, torch.where(accept, cost1, cost0), accept


def adjust(p: BAProblem, cfg: BAConfig = BAConfig(), verbose=False, group=None,
           shard_points=False):
    """Full LM loop: at most max_iterations steps, stopped once an accepted
    step improves the cost by at most function_tolerance (relative) or lam
    exceeds 1e10.  Returns (problem, final cost, accepted step count).
    `group` and `shard_points`: this rank's shard of a sharded solve (see
    lm_step)."""
    with span("ba.adjust"):
        cam_fast = cam_fast_ok(p)
        with span("ba.plans"):
            p = with_plans(p, group, cam_fast)
        lam = torch.as_tensor(cfg.lam_init, dtype=p.X.dtype, device=p.X.device)
        cost = host_read(robust_cost(p, cfg, cam_fast, group))
        n_acc = 0
        for it in range(cfg.max_iterations):
            p, lam, new_cost, accept = lm_step(p, lam, cfg, cam_fast, group, shard_points)
            new_cost, accept, lam_f = host_read(new_cost), host_read(accept), host_read(lam)
            n_acc += int(accept)
            count("ba.lm_accepted", int(accept))
            if verbose:
                print(f"  LM it={it} cost={new_cost:.6g} lam={lam_f:.3g} accept={accept}")
            converged = accept and cost - new_cost <= cfg.function_tolerance * max(cost, 1e-30)
            cost = new_cost
            if converged or lam_f > 1e10:
                break
    return p, cost, n_acc


# ---------------------------------------------------------------------------
# scene <-> problem
# ---------------------------------------------------------------------------

def problem_from_reference(fields, dtype=torch.float64, device="cpu"):
    """BAProblem fields as numpy arrays -> the port's BAProblem (ids int64,
    the rest `dtype`).  `pt_obs` is None, a (rows, row_point, groups) tuple
    or a dict of them.  The reference's BAProblem fields, converted with
    np.asarray, feed one problem to both packages."""
    ints = ("obs_pose", "obs_intr", "obs_point", "intr_kind")
    out = {}
    for f in BAProblem._fields[:16]:
        a = np.asarray(fields[f])
        t = torch.as_tensor(a.astype(np.int64) if f in ints else a.astype(np.float64),
                            device=device)
        out[f] = t if f in ints else t.to(dtype)
    t = fields.get("pt_obs")
    if t is not None:
        rows, row_point, groups = (t[k] for k in ("rows", "row_point", "groups")) \
            if isinstance(t, dict) else t

        def it(a):
            return None if a is None else torch.as_tensor(np.asarray(a, np.int64),
                                                          device=device)

        out["pt_obs"] = PtObsTable(rows=it(rows), row_point=it(row_point), groups=it(groups))
    return BAProblem(**out)


def problem_from_scene(scene, refine_rotation=True, refine_translation=True,
                       refine_intrinsics=ADJUST_NONE, refine_structure=True,
                       dtype=torch.float32, device="cpu", use_gps_priors=False,
                       use_control_points=True):
    """Build a BAProblem from a Scene (Optimize_Options parity).

    refine_intrinsics: ADJUST_NONE | ADJUST_ALL | iterable of column ids.
    Pose/intrinsic/landmark ids are compacted to the used subsets; returns
    (problem, index_maps) with the original ids in the maps.  The
    observations take the point-major layout with no padding beyond it
    (the reference pads to powers of two only to spare XLA recompiles)."""
    info = scene.obs_arrays_for_ba()
    n_cp = len(scene.cp_X) if use_control_points else 0
    if n_cp:
        cp_pid = scene.view_pose[scene.cp_obs_view]
        cp_ok = (cp_pid >= 0) & scene.pose_valid[np.clip(cp_pid, 0, max(scene.n_poses - 1, 0))]
        info = dict(
            obs_idx=info["obs_idx"],
            pose_id=np.concatenate([info["pose_id"], cp_pid[cp_ok]]),
            intr_id=np.concatenate([info["intr_id"],
                                    scene.view_intrinsic[scene.cp_obs_view[cp_ok]]]),
            landmark_id=np.concatenate([info["landmark_id"],
                                        len(scene.X_valid) + scene.cp_obs_landmark[cp_ok]]),
            x=np.concatenate([info["x"], scene.cp_obs_x[cp_ok]]))
    pose_ids = np.unique(info["pose_id"])
    intr_ids = np.unique(info["intr_id"])
    point_ids = np.unique(info["landmark_id"])

    def compact(ids, uniq):
        return np.searchsorted(uniq, ids).astype(np.int64) if len(ids) else np.zeros(0, np.int64)

    obs_pose = compact(info["pose_id"], pose_ids)
    obs_intr = compact(info["intr_id"], intr_ids)
    obs_point = compact(info["landmark_id"], point_ids)
    R = scene.pose_R[pose_ids]
    rotvec = hostmath.logmap_np(R)
    t = -np.einsum("nij,nj->ni", R, scene.pose_C[pose_ids])

    mask_pose = np.zeros((len(pose_ids), 6))
    if refine_rotation:
        mask_pose[:, :3] = 1.0
    if refine_translation:
        mask_pose[:, 3:] = 1.0
    mask_intr = np.zeros((len(intr_ids), 8))
    kinds = np.asarray(scene.cameras.kind)[intr_ids]
    if refine_intrinsics == ADJUST_ALL:
        for i, k in enumerate(kinds):
            mask_intr[i, :cm.N_PARAMS[int(k)]] = 1.0
    elif refine_intrinsics != ADJUST_NONE:
        for col in refine_intrinsics:
            mask_intr[:, col] = 1.0
        for i, k in enumerate(kinds):
            mask_intr[i, cm.N_PARAMS[int(k)]:] = 0.0

    n_obs, n_pose, n_pts = len(obs_pose), len(pose_ids), len(point_ids)
    obs_pose, obs_intr, obs_point, obs_x, obs_w, pt_table = point_major_layout(
        obs_pose, obs_intr, obs_point, np.asarray(info["x"], np.float64), np.ones(n_obs),
        n_pts)
    X_all = np.concatenate([scene.X, scene.cp_X]) if n_cp else scene.X
    mask_vals = np.full(n_pts, 1.0 if refine_structure else 0.0)
    if n_cp:
        mask_vals[point_ids >= len(scene.X_valid)] = 0.0  # GCPs stay fixed
    prior_C = np.zeros((n_pose, 3))
    prior_w = np.zeros((n_pose, 3))
    if use_gps_priors and scene.prior_center is not None:
        pm = {int(v): i for i, v in enumerate(pose_ids)}
        for v in range(scene.n_views):
            w = scene.prior_center_weight[v]
            pid = int(scene.view_pose[v])
            if np.any(w > 0) and pid in pm:
                prior_C[pm[pid]] = scene.prior_center[v]
                prior_w[pm[pid]] = w
    cams = scene.cameras
    fields = dict(obs_pose=obs_pose, obs_intr=obs_intr, obs_point=obs_point,
                  obs_x=obs_x, obs_w=obs_w, rotvec=rotvec, t=t,
                  intr_kind=np.asarray(cams.kind)[intr_ids],
                  intr_wh=np.stack([np.asarray(cams.width)[intr_ids],
                                    np.asarray(cams.height)[intr_ids]], -1),
                  intr_params=np.asarray(cams.params)[intr_ids], X=X_all[point_ids],
                  mask_pose=mask_pose, mask_intr=mask_intr, mask_X=mask_vals,
                  prior_C=prior_C, prior_w=prior_w, pt_obs=pt_table)
    return problem_from_reference(fields, dtype, device), dict(
        pose_ids=pose_ids, intr_ids=intr_ids, point_ids=point_ids,
        n_scene_points=len(scene.X_valid))


def scene_from_problem(scene, p: BAProblem, maps):
    """Write the optimised parameters back into the Scene (in place); rows
    beyond the index maps (a padded problem taken from the reference's)
    are ignored."""
    nP = len(maps["pose_ids"])
    nL = len(maps["point_ids"])
    with span("host_read"):
        rotvec = p.rotvec[:nP].cpu().double().numpy()
        t = p.t[:nP].cpu().double().numpy()
        params = p.intr_params[:len(maps["intr_ids"])].cpu().double().numpy()
        Xout = p.X[:nL].cpu().double().numpy()
    R = hostmath.expmap_np(rotvec)
    scene.pose_R[maps["pose_ids"]] = R
    scene.pose_C[maps["pose_ids"]] = -np.einsum("nji,nj->ni", R, t)
    newp = np.asarray(scene.cameras.params).copy()
    newp[maps["intr_ids"]] = params
    scene.cameras = scene.cameras._replace(params=newp)
    pids = maps["point_ids"]
    n_scene = maps.get("n_scene_points")
    keep = pids < n_scene if n_scene is not None else np.ones(len(pids), bool)
    scene.X[pids[keep]] = Xout[keep]
    return scene
