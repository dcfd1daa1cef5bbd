"""The bundle adjuster's closed-form Jacobians of the polynomial camera
kinds on the card (openmvg_torch/sfm/ba.py::_poly_r_J), at BAL
Dubrovnik's size and layout (benchmark/configs/bal-dubrovnik-356.json:
camera model 3, 1,255,268 observations in 1,600,800 slots): the float32
blocks against the float64 forward-mode blocks, and one pass's allocator
peak a slot against JAC_CLOSED_BYTES_PER_SLOT.  On a machine with a card
(which need not have JAX; the repo's conftest imports it, hence
--noconftest):

    python -m pytest --noconftest tests/test_torch_ba_closed_form_cuda.py -q -s

The float32 rounding of a block entry scales with the largest entry of
its block row (the chain sums terms of that size, which cancel) and with
the rounding R X + t leaves in Xc, so each block is held to 1e-5 (1 + S),
S that magnitude of the float64 block row times (|X| + |t|) / |z|; the
residuals to 1e-5 (1 + S), S the magnitudes summed into them.
-s prints the peak bytes a slot of each path and the largest scaled
errors of both float32 paths.
"""

import json
import os

import pytest
import torch

from benchmark.drivers import ba_solve
from benchmark.gen import bal
from openmvg_torch.geometry import so3
from openmvg_torch.sfm import ba

pytestmark = pytest.mark.cuda

CONFIG = os.path.join(os.path.dirname(__file__), "..", "benchmark", "configs",
                      "bal-dubrovnik-356.json")


@pytest.fixture(scope="module")
def dubrovnik():
    """The problem in float32 on the card, and the same numbers in float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the measured path runs there")
    with open(CONFIG) as f:
        cfg = json.load(f)
    prob = bal.make_problem(None, cfg["n_cameras"], cfg["n_points"], cfg["n_observations"],
                            cfg["noise_px"], cfg["outlier_share"], cfg["problem_seed"])
    # the camera-3 distortion a solve reaches (the start holds k1 = k2 = 0)
    p32 = ba_solve.program_problem(prob._replace(intr0=prob.intr), cfg, "cuda")
    floats = ("obs_x", "obs_w", "rotvec", "t", "intr_wh", "intr_params", "X", "mask_pose",
              "mask_intr", "mask_X", "prior_C", "prior_w")
    return p32, p32._replace(**{k: getattr(p32, k).double() for k in floats})


def _scaled_err(got, ref, S):
    return float(((got.double() - ref).abs() / (1.0 + S)).max())


def test_float32_closed_form_matches_float64_forward_mode(dubrovnik):
    """The raw blocks on the observed slots (a point-major row's slack
    slots, weight 0, project the row's point through camera 0, anywhere),
    the float32 closed form against float64 forward mode on the same
    numbers.  R X + t sums terms of |X| + |t| into Xc, and near the image's
    centre cancels, so the normalised point (x, y) = Xc / z carries float32
    rounding of (|X| + |t|) / z: a block row's S is its largest magnitude
    times that factor, the residual's the magnitudes summed into it,
    |x_obs| + |dr/dt| |t| + |dr/dX| |X|."""
    p32, p64 = dubrovnik
    assert ba.cam_fast_ok(p32) == ba.JAC_POLY
    seen = p64.obs_w > 0
    ref = [b[seen] for b in ba._generic_r_J(p64)]
    t, X = p64.t[p64.obs_pose][seen], ba._pt_expand(p64.X, p64)[seen]
    z = (so3.rotate(p64.rotvec[p64.obs_pose][seen], X) + t)[:, 2]
    kappa = ((X.abs().sum(-1) + t.abs().sum(-1)) / z.abs())[:, None, None]
    S_r = (p64.obs_x[seen].abs() + (ref[1][..., 3:].abs() * t.abs()[:, None]).sum(-1)
           + (ref[3].abs() * X.abs()[:, None]).sum(-1))
    for name, fn in (("closed form", ba._poly_r_J), ("forward mode", ba._generic_r_J)):
        got = fn(p32)
        if name == "closed form":
            assert all(g.dtype == torch.float32 for g in got)
        got = [g[seen] for g in got]
        errs = [_scaled_err(got[0], ref[0], S_r)]
        errs += [_scaled_err(g, r, r.abs().amax(-1, keepdim=True) * kappa)
                 for g, r in zip(got[1:], ref[1:])]
        print(f"float32 {name}: largest |err| / (1 + S) of r, Jp6, Ji8, Jx3: "
              + ", ".join(f"{e:.3e}" for e in errs))
        if name == "closed form":
            assert max(errs) <= 1e-5, errs
        del got


def _peak_a_slot(p, path):
    cfg = ba.BAConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = ba.jacobians(p, cfg, path)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak / p.obs_pose.shape[0]


def test_one_pass_peaks_under_the_closed_form_s_bytes_a_slot(dubrovnik):
    """torch.cuda.max_memory_allocated over one pass of jacobians on the
    closed form, less what was allocated before it, over the slots: the way
    JAC_CLOSED_BYTES_PER_SLOT (and JAC_BYTES_PER_SLOT for forward mode) was
    measured."""
    p = dubrovnik[0]
    assert p.jac_slots is None
    closed = _peak_a_slot(p, ba.JAC_POLY)
    generic = _peak_a_slot(p, ba.JAC_GENERIC)
    pinhole = _peak_a_slot(p, ba.JAC_PINHOLE)
    print(f"peak bytes a slot at {p.obs_pose.shape[0]} slots: closed form {closed:.2f}, "
          f"pinhole {pinhole:.2f}, forward mode {generic:.2f}; "
          f"{torch.cuda.get_device_name(0)}")
    assert closed <= ba.JAC_CLOSED_BYTES_PER_SLOT
    assert pinhole <= ba.JAC_CLOSED_BYTES_PER_SLOT
    assert generic <= ba.JAC_BYTES_PER_SLOT
