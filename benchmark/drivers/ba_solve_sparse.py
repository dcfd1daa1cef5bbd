"""Driver of bundle-adjustment solves on a BAL problem too large for the
dense reference: ba_solve's set-up, fresh copies and window (imported,
unchanged), with a check and a control through
reference/bal_lm_sparse.py, which solves each LM step without forming
the reduced camera system densely.

The check, with the program's state freed, works out again in float64
the robust cost C of every solve of the window from its parameters, and
runs the sparse float64 reference for REFERENCE_STEPS LM steps from one
solve drawn from the seed, to C*: ba_excess = (C - C*) / C*, the worst
solve, as ba_solve's check reads it.  REFERENCE_STEPS is 5, not
ba_solve's 10: at BAL Final each step's CG to 1e-12 takes more
iterations as LM's damping falls (1,145 at the first step, 12,673 at the
tenth, about 6 ms each on an H100): where every step was accepted, 10
steps took 381.7 s, more than seven windows of the cell; the first 5 take
about 15,700 iterations, about 95 s.

The control stands in for the reference computed in TF32: the
reference's own float64 solve from the seeded start, as many LM steps as
the cell's solves take (the traffic's max_iterations), every rotation (as
a rotation vector), translation, intrinsic and point then held in TF32
(10 mantissa bits); check() reads it as one solve of the window.
"""

import math
import random
import time

import numpy as np
from scipy.spatial.transform import Rotation

from benchmark.drivers.ba_solve import (NO_WARMUP, TF32_BITS, fresh,  # noqa: F401
                                        reference_inputs, setup, window)

REFERENCE_STEPS = 5
CONTROLS = ("tf32",)


def _reference_params(sol, device):
    """A solve's parameters in the reference's form, float64: (R, t,
    (f, k1, k2), X) and the held (principal point, k3)."""
    import torch

    from benchmark.reference import bal_lm_sparse

    rotvec, t, params, X = (torch.as_tensor(a).to(device=device, dtype=torch.float64)
                            for a in sol[:4])
    return (bal_lm_sparse.expm_so3(rotvec), t, params[:, [0, 3, 4]], X), (params[:, 1:3],
                                                                            params[:, 5])


def solution_cost(sol, data, device):
    """The reference's float64 robust cost of one of the program's solves,
    every radial-3 parameter as the program left it."""
    from benchmark.reference import bal_lm_sparse

    start, (pp, k3) = _reference_params(sol, device)
    return bal_lm_sparse.robust_cost(*start, *data, pp=pp, k3=k3)


def excess(sols, data, device, pick, log=None):
    """(C_i - C*) / C* for each solve i, C* the reference's cost after
    REFERENCE_STEPS steps from solve `pick`; and C*."""
    from benchmark.reference import bal_lm_sparse

    start, (pp, k3) = _reference_params(sols[pick], device)
    stats = []
    *_, best, _ = bal_lm_sparse.solve(*start, *data, max_iterations=REFERENCE_STEPS, pp=pp,
                                      k3=k3, stats=stats)
    if log is not None:
        log(f"reference steps: {stats}")
    return [(solution_cost(s, data, device) - best) / best for s in sols], best


def control(state, out, name, log):
    """The control in the program's place (see the module note)."""
    import torch

    from benchmark.reference import bal_lm_sparse, sfm_check

    assert name == "tf32", name
    state.p0 = None
    if str(state.device).startswith("cuda"):
        torch.cuda.empty_cache()
    start, data = reference_inputs(state.problem, state.device, torch.float64)
    R, t, intr, X, ref_cost, steps = bal_lm_sparse.solve(
        *start, *data, max_iterations=state.traffic["max_iterations"])
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
    ex, best = excess(sols, data, state.device, pick, log)
    log(f"reference: {REFERENCE_STEPS} steps from solve {pick} to cost {best!r} in "
        f"{time.perf_counter() - t0:.3f} s; the program's solves: costs "
        f"{[s[4] for s in sols]}, excess {ex}")
    # a reading that is not a number fails, wherever it stands
    worst = max(e if math.isfinite(e) else math.inf for e in ex)
    return {"ba_excess": dict(value=worst, limit=limits["ba_excess"],
                              ok=bool(worst <= limits["ba_excess"]))}
