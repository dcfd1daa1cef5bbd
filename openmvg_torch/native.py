"""The reference's CPU baselines (counterpart: openmvg_tpu/native/
__init__.py::bench_match_2nn and bench_ba_lm_step), the numbers a card
kernel is compared with: csrc/bench_native.cpp, built with g++, OpenMP and
-march=native into openmvg_torch/_build/ at first use.  Unlike the
reference, these return results always: a library that fails to build
raises.
"""

import numpy as np

from openmvg_torch.utils.build import bench_library


def bench_match_2nn(desc_a, desc_b, ratio=0.8):
    """Brute-force uint8 L2 2-NN + ratio test on the CPU: for each row of
    desc_a, the index of its nearest row of desc_b (the first of equal
    ones) and whether best < ratio^2 * second (squared distances).
    Returns (idx, keep) int32 arrays."""
    a = np.ascontiguousarray(desc_a, np.uint8)
    b = np.ascontiguousarray(desc_b, np.uint8)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1] or a.shape[1] % 32:
        raise ValueError(f"descriptors of equal width, a multiple of 32: {a.shape}, {b.shape}")
    idx = np.empty(len(a), np.int32)
    keep = np.empty(len(a), np.int32)
    bench_library().omt_bench_match_2nn(a, len(a), b, len(b), a.shape[1], float(ratio), idx,
                                        keep)
    return idx, keep


def bench_ba_lm_step(obs_pose, obs_point, obs_x, rotvec, t, X, f, cx, cy, lam=1e-4,
                     cg_iters=20, huber_a=16.0):
    """One CPU implicit-Schur LM step with the pinhole intrinsics fixed
    (the ceres-class baseline).  rotvec, t and X (float64, C-contiguous)
    are updated in place when the step is accepted.  Returns (accepted,
    cost before, cost after)."""
    for arr in (rotvec, t, X):
        if arr.dtype != np.float64 or not arr.flags.c_contiguous:
            raise ValueError("rotvec, t and X must be C-contiguous float64")
    out2 = np.zeros(2)
    rc = bench_library().omt_bench_ba_lm_step(
        np.ascontiguousarray(obs_pose, np.int32), np.ascontiguousarray(obs_point, np.int32),
        np.ascontiguousarray(obs_x, np.float64).ravel(), rotvec.ravel(), t.ravel(), X.ravel(),
        float(f), float(cx), float(cy), len(obs_pose), len(rotvec), len(X), float(lam),
        int(cg_iters), float(huber_a), out2)
    if rc < 0:
        raise RuntimeError(f"omt_bench_ba_lm_step returned {rc}")
    return bool(rc), float(out2[0]), float(out2[1])
