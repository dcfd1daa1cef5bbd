"""Final float64 polish of a reconstruction (counterpart:
openmvg_tpu/sfm/polish.py).

The engine's bundle adjuster runs float32 on the card; a short
double-precision LM tail on the host then refines poses, structure and
the shared pinhole intrinsics jointly (the three intrinsic unknowns ride
the Schur-reduced CG system as one extra global block), with the port's
copy of the reference's native step (csrc/native.cpp, omt_ba_lm_step_k),
built with g++ and OpenMP into openmvg_torch/_build/ at first use.  The
copy sums over fixed blocks of observations in a fixed order, so a run
repeats bit for bit whatever the thread count.

It applies to a scene with one shared plain-PINHOLE intrinsic and returns
0 for any other.  Unlike the reference, a library that fails to build
raises instead of skipping the polish.
"""

import numpy as np
import torch

from openmvg_torch.models import cameras as cm
from openmvg_torch.utils import deadline, hostmath
from openmvg_torch.utils.build import host_library as build


def ba_lm_step_k(obs_pose, obs_point, obs_x, rotvec, t, X, kparams, refine_k=True,
                 lam=1e-4, cg_iters=20, huber_a=16.0, n_threads=None):
    """One host LM step.  rotvec, t, X and kparams ([f, cx, cy]) are
    float64 C-contiguous and are updated in place when the step is
    accepted.  n_threads (default: torch's intra-op thread count) does not
    change the result.  Returns (accepted, cost before, cost after)."""
    lib = build()
    for a in (rotvec, t, X, kparams):
        if a.dtype != np.float64 or not a.flags.c_contiguous:
            raise ValueError("rotvec, t, X and kparams must be C-contiguous float64")
    out2 = np.zeros(2)
    rc = lib.omt_ba_lm_step_k(
        np.ascontiguousarray(obs_pose, np.int32), np.ascontiguousarray(obs_point, np.int32),
        np.ascontiguousarray(obs_x, np.float64).ravel(), rotvec.ravel(), t.ravel(),
        X.ravel(), kparams, int(bool(refine_k)), len(obs_pose), len(rotvec), len(X),
        float(lam), int(cg_iters), float(huber_a),
        int(n_threads or torch.get_num_threads()), out2)
    if rc < 0:
        raise RuntimeError(f"omt_ba_lm_step_k returned {rc}")
    return bool(rc), float(out2[0]), float(out2[1])


def f64_polish(scene, max_steps=48, cg_iters=30, lam=1e-6, function_tolerance=1e-12,
               refine_intrinsics=True):
    """In-place float64 pose + structure (+ shared intrinsic) LM tail.
    Returns the number of accepted steps (0 when the scene does not have
    one shared PINHOLE intrinsic or has no observations)."""
    kinds = np.asarray(scene.cameras.kind)
    if len(kinds) != 1 or int(kinds[0]) != cm.PINHOLE:
        return 0
    info = scene.obs_arrays_for_ba()
    if len(info["obs_idx"]) == 0:
        return 0
    build()
    pose_ids = np.unique(info["pose_id"])
    point_ids = np.unique(info["landmark_id"])
    obs_pose = np.searchsorted(pose_ids, info["pose_id"]).astype(np.int32)
    obs_point = np.searchsorted(point_ids, info["landmark_id"]).astype(np.int32)
    obs_x = np.ascontiguousarray(info["x"], np.float64)
    R = scene.pose_R[pose_ids]
    rotvec = np.ascontiguousarray(hostmath.logmap_np(R), np.float64)
    t = np.ascontiguousarray(-np.einsum("nij,nj->ni", R, scene.pose_C[pose_ids]), np.float64)
    X = np.ascontiguousarray(scene.X[point_ids], np.float64)
    kp = np.ascontiguousarray(np.asarray(scene.cameras.params, np.float64)[0, 0:3])

    accepted = 0
    for _ in range(max_steps):
        ok, c0, c1 = ba_lm_step_k(obs_pose, obs_point, obs_x, rotvec, t, X, kp,
                                  refine_k=refine_intrinsics, lam=lam, cg_iters=cg_iters)
        if ok:
            accepted += 1
            lam = max(lam * 0.5, 1e-12)
            if c0 - c1 <= function_tolerance * max(c0, 1e-30):
                break
        else:
            lam *= 4.0
            if lam > 1e8:
                break
        if deadline.past():
            break
    if accepted:
        Rn = hostmath.expmap_np(rotvec)
        scene.pose_R[pose_ids] = Rn
        scene.pose_C[pose_ids] = -np.einsum("nji,nj->ni", Rn, t)
        scene.X[point_ids] = X
        if refine_intrinsics:
            p = np.array(scene.cameras.params, np.float64)
            p[0, 0:3] = kp
            scene.cameras = scene.cameras._replace(params=p)
    return accepted
