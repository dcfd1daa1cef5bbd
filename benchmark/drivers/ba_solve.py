"""Driver of bundle-adjustment solves (the `refine` tool's work without
its file IO) on a BAL problem synthesised from the seed.

Set-up draws the problem (gen/bal.py, one problem whatever the seed),
lays it out as the program takes it (sfm.ba.point_major_layout, then
sfm.ba.problem_from_reference, in the configuration's dtype on the card)
and warms up with one LM step.  The window runs solves back to back,
each sfm.ba.adjust from a fresh copy of the start, without the plans, so
that each builds them as `refine` does, and with its cameras relabelled
by a permutation drawn from the seed and the solve's index.  The LM's
stopping test reads float32 costs, so the order of the camera sums
decides on which step some solves stop (3.6-6.5 s a solve): a run
averages over its solves' orders instead of the seed fixing one.  The
window's last solve is finished and counted, and ba_solve_s is the
window's seconds over its solves.

The check, with the program's state freed, works out again in float64
the robust cost C of every solve of the window from its parameters, and
runs the plain float64 reference (reference/bal_lm.py) for
REFERENCE_STEPS LM steps from one solve drawn from the seed, to C*:
ba_excess = (C - C*) / C*, the worst solve.  A sound solve ends near a
minimum, so the reference gains little from it; the robust cost has
many local minima (outliers on two-view points), so the reference is
started from the program's answer rather than compared from the start.
"""

import math
import random
import time
from types import SimpleNamespace

import numpy as np
from scipy.spatial.transform import Rotation

from benchmark.gen import bal

REFERENCE_STEPS = 10
TF32_BITS = 10
CONTROLS = ("tf32",)
NO_WARMUP = {"warmup_steps": 0}

def program_problem(p, cfg, device):
    """The program's BAProblem of a BALProblem: one PINHOLE_CAMERA_RADIAL3
    intrinsic a camera, f, k1 and k2 free, principal point and k3 held."""
    import torch

    from openmvg_torch.sfm import ba

    n_cams, n_points, O = len(p.R0), len(p.X0), len(p.cam)
    obs_pose, obs_intr, obs_point, obs_x, obs_w, table = ba.point_major_layout(
        p.cam, p.cam, p.point, p.x, np.ones(O), n_points)
    params = np.zeros((n_cams, 8))
    params[:, 0], params[:, 3], params[:, 4] = p.intr0[:, 0], p.intr0[:, 1], p.intr0[:, 2]
    mask_intr = np.zeros((n_cams, 8))
    mask_intr[:, [0, 3, 4]] = 1.0
    fields = dict(obs_pose=obs_pose, obs_intr=obs_intr, obs_point=obs_point, obs_x=obs_x,
                  obs_w=obs_w, rotvec=Rotation.from_matrix(p.R0).as_rotvec(), t=p.t0,
                  intr_kind=np.full(n_cams, cfg["camera_model"]),
                  intr_wh=np.tile(cfg["image_wh"], (n_cams, 1)),
                  intr_params=params, X=p.X0, mask_pose=np.ones((n_cams, 6)),
                  mask_intr=mask_intr, mask_X=np.ones(n_points),
                  prior_C=np.zeros((n_cams, 3)), prior_w=np.zeros((n_cams, 3)), pt_obs=table)
    return ba.problem_from_reference(fields, getattr(torch, cfg["dtype"]), device)


def fresh(p0, q=None):
    """A copy of the start whose parameters the solve may replace; with q
    (a permutation of the cameras, on the device) camera c is labelled
    q[c], and each camera row moves with it."""
    import torch

    p = p0._replace(X=p0.X.clone(), seg_plans=None, point_plan=None)
    if q is None:
        return p._replace(rotvec=p0.rotvec.clone(), t=p0.t.clone(),
                          intr_params=p0.intr_params.clone())
    q_inv = torch.argsort(q)
    rows = {f: getattr(p0, f)[q_inv] for f in ("rotvec", "t", "intr_kind", "intr_wh",
                                              "intr_params", "mask_pose", "mask_intr",
                                              "prior_C", "prior_w")}
    return p._replace(obs_pose=q[p0.obs_pose], obs_intr=q[p0.obs_intr], **rows)



def setup(cfg, traffic, seed, device, work, log):
    import torch

    from openmvg_torch.ops import seg_sum
    from openmvg_torch.sfm import ba

    t0 = time.perf_counter()
    if str(device).startswith("cuda"):
        seg_sum.build()
    build_s = time.perf_counter() - t0
    prob = bal.make_problem(None, cfg["n_cameras"], cfg["n_points"], cfg["n_observations"],
                            cfg["noise_px"], cfg["outlier_share"], cfg["problem_seed"])
    p0 = program_problem(prob, cfg, device)
    log(f"problem of {len(prob.cam)} observations in {time.perf_counter() - t0 - build_s:.3f} s")
    solve_cfg = ba.BAConfig(max_iterations=traffic["max_iterations"])
    ba.adjust(fresh(p0), solve_cfg._replace(max_iterations=traffic["warmup_steps"]))
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()
    # more orders than a window can use (a solve takes 3.6 s or more)
    orders = [torch.as_tensor(np.random.default_rng((seed % 2 ** 64, k)).permutation(
        len(prob.R0)), device=device) for k in range(64)]
    return SimpleNamespace(cfg=cfg, traffic=traffic, problem=prob, p0=p0, solve_cfg=solve_cfg,
                           device=device, build_s=build_s, seed=seed, orders=orders,
                           solutions=[])


def window(state, seconds, rec):
    from openmvg_torch.sfm import ba

    attempted = 0
    t0 = time.perf_counter()
    ends = []
    while True:
        rec.unit = attempted
        q = state.orders[attempted % len(state.orders)]
        p, cost, _ = ba.adjust(fresh(state.p0, q), state.solve_cfg)
        attempted += 1
        rec.units = attempted
        # back to the problem's own camera labels
        state.solutions.append((p.rotvec[q], p.t[q], p.intr_params[q], p.X, cost))
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    elapsed = time.perf_counter() - t0
    state.unit_s = [b - a for a, b in zip([0.0] + ends, ends)]
    return dict(attempted=attempted, failed=0, window_s=elapsed,
                metrics={"ba_solve_s": elapsed / attempted})


def reference_inputs(prob, device, dtype):
    import torch

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return ((t(prob.R0), t(prob.t0), t(prob.intr0), t(prob.X0)),
            (torch.as_tensor(prob.cam, device=device), torch.as_tensor(prob.point, device=device),
             t(prob.x)))


def _reference_params(sol, device):
    """A solve's parameters in the reference's form, float64: (R, t,
    (f, k1, k2), X) and the held (principal point, k3)."""
    import torch

    from benchmark.reference import bal_lm

    rotvec, t, params, X = (torch.as_tensor(a).to(device=device, dtype=torch.float64)
                            for a in sol[:4])
    return (bal_lm.expm_so3(rotvec), t, params[:, [0, 3, 4]], X), (params[:, 1:3],
                                                                     params[:, 5])


def solution_cost(sol, data, device):
    """The reference's float64 robust cost of one of the program's solves,
    every radial-3 parameter as the program left it."""
    from benchmark.reference import bal_lm

    start, (pp, k3) = _reference_params(sol, device)
    return bal_lm.robust_cost(*start, *data, pp=pp, k3=k3)


def excess(sols, data, device, pick):
    """(C_i - C*) / C* for each solve i, C* the reference's cost after
    REFERENCE_STEPS steps from solve `pick`; and C*."""
    from benchmark.reference import bal_lm

    start, (pp, k3) = _reference_params(sols[pick], device)
    *_, best, _ = bal_lm.solve(*start, *data, max_iterations=REFERENCE_STEPS, pp=pp, k3=k3)
    return [(solution_cost(s, data, device) - best) / best for s in sols], best


def reference_solve(prob, device, dtype):
    """The reference's own solve from the start (the control's answer)."""
    from benchmark.reference import bal_lm

    start, data = reference_inputs(prob, device, dtype)
    return bal_lm.solve(*start, *data)


def control(state, out, name, log):
    """The control in the program's place: the plain reference's own
    float64 solve from the start, every rotation (as a rotation vector),
    translation, intrinsic and point held in TF32 (10 mantissa bits);
    check() then reads it as one solve of the window."""
    import torch

    from benchmark.reference import sfm_check

    assert name == "tf32", name
    R, t, intr, X, ref_cost, steps = reference_solve(state.problem, state.device,
                                                     torch.float64)
    log(f"control: the reference's own solve, {steps} steps to cost {ref_cost!r}")
    params = torch.zeros((len(R), 8), dtype=torch.float64)
    params[:, [0, 3, 4]] = intr.cpu()
    rotvec = Rotation.from_matrix(R.cpu().numpy()).as_rotvec()
    low = [torch.as_tensor(sfm_check.round_mantissa(np.asarray(a), TF32_BITS))
           for a in (rotvec, t.cpu(), params, X.cpu())]
    state.solutions = [(*low, ref_cost)]
    return dict(out, attempted=1, failed=0)


def check(state, out, limits, log):
    import torch

    sols = [tuple(a.cpu() if hasattr(a, "cpu") else a for a in s) for s in state.solutions]
    state.solutions.clear()
    state.p0 = None
    if str(state.device).startswith("cuda"):
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, data = reference_inputs(state.problem, state.device, torch.float64)
    pick = random.Random(state.seed).randrange(len(sols))
    ex, best = excess(sols, data, state.device, pick)
    log(f"reference: {REFERENCE_STEPS} steps from solve {pick} to cost {best!r} in "
        f"{time.perf_counter() - t0:.3f} s; the program's solves: costs "
        f"{[s[4] for s in sols]}, excess {ex}")
    # a reading that is not a number fails, wherever it stands
    worst = max(e if math.isfinite(e) else math.inf for e in ex)
    return {"ba_excess": dict(value=worst, limit=limits["ba_excess"],
                              ok=bool(worst <= limits["ba_excess"]))}
