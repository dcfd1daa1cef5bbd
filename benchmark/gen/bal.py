"""A bundle-adjustment problem at the counts of a BAL problem, from a seed.

Bundle Adjustment in the Large (Agarwal, Snavely, Seitz, Szeliski, ECCV
2010) publishes its problems as cameras, points and observations; this
module draws one with the same counts (numpy, on the host, in
whole-array calls).  The problem is one problem, as Dubrovnik is: all
of it comes from a fixed problem seed.  A seed, where one is given,
draws only the order of its cameras and of its points: the same problem
under other labels.  Each camera has its own
intrinsics (f, k1, k2), held as openMVG's PINHOLE_CAMERA_RADIAL3 with
the principal point and k3 at 0, as BAL's model is.  What the published
files do not fix is drawn here and listed in the configuration's
`assumed`:

  cameras   on a ring of radius 3 around the scene, at heights and aim
            points jittered, each looking toward the origin
  points    in a 2 x 2 x 0.8 box at the origin
  tracks    lengths from a discretised log-normal (sigma 0.8), at least 2,
            summing to the published observation count exactly; a
            point's cameras are a run of the ring at a stride of 1-3
  noise     0.5 px Gaussian, and a share of outliers moved by up to
            +-30 px on each axis
  start     poses, centres, points and focal lengths perturbed, k1 = k2 = 0

Observations are in point order (each point's observations contiguous).
"""

from typing import NamedTuple

import numpy as np


class BALProblem(NamedTuple):
    cam: np.ndarray       # (O,) int64 camera of each observation
    point: np.ndarray     # (O,) int64 point of each observation
    x: np.ndarray         # (O, 2) observed pixels (principal point at 0)
    R0: np.ndarray        # (C, 3, 3) start rotations, world -> camera
    t0: np.ndarray        # (C, 3) start translations (x_c = R X + t)
    intr0: np.ndarray     # (C, 3) start (f, k1, k2)
    X0: np.ndarray        # (L, 3) start points
    R: np.ndarray         # the truth the observations were drawn from
    t: np.ndarray
    intr: np.ndarray
    X: np.ndarray


def _look_at(C, target):
    """World -> camera rotations (N, 3, 3), +z toward target, up = +z."""
    z = target - C
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    x = np.cross(np.array([0.0, 0.0, 1.0]), z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)


def _rodrigues(w):
    """(N, 3) rotation vectors -> (N, 3, 3) matrices."""
    th = np.linalg.norm(w, axis=1)[:, None, None]
    k = w / np.maximum(th[:, :, 0], 1e-300)
    Kx = np.zeros((len(w), 3, 3))
    Kx[:, 0, 1], Kx[:, 0, 2], Kx[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    Kx = Kx - Kx.transpose(0, 2, 1)
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def track_lengths(rng, n_points, n_obs, n_cams, sigma=0.8):
    """n_points lengths in [2, n_cams] summing to n_obs exactly."""
    mean = n_obs / n_points
    k = np.rint(np.exp(rng.normal(np.log(mean) - sigma * sigma / 2, sigma, n_points)))
    k = np.clip(k, 2, n_cams).astype(np.int64)
    while True:
        diff = n_obs - int(k.sum())
        if diff == 0:
            return k
        room = np.nonzero(k < n_cams if diff > 0 else k > 2)[0]
        pick = rng.choice(room, min(abs(diff), len(room)), replace=False)
        k[pick] += 1 if diff > 0 else -1


def project(R, t, intr, X, cam, point):
    """Pixels (O, 2) of PINHOLE_CAMERA_RADIAL3 with the principal point at 0."""
    Xc = np.einsum("oij,oj->oi", R[cam], X[point]) + t[cam]
    p = Xc[:, :2] / Xc[:, 2:]
    r2 = (p * p).sum(1, keepdims=True)
    f, k1, k2 = (intr[cam, i:i + 1] for i in range(3))
    return f * (1 + k1 * r2 + k2 * r2 * r2) * p


def make_problem(seed, n_cams, n_points, n_obs, noise_px=0.5, outlier_share=0.01,
                 problem_seed=0):
    """The problem of `problem_seed`, its cameras and points relabelled by
    permutations drawn from `seed` (observations in the new point order),
    or as drawn where `seed` is None."""
    rng = np.random.default_rng(problem_seed)
    phi = 2 * np.pi * (np.arange(n_cams) + rng.uniform(-0.3, 0.3, n_cams)) / n_cams
    C = np.stack([3 * np.cos(phi), 3 * np.sin(phi), rng.uniform(-0.3, 0.3, n_cams)], 1)
    R = _look_at(C, rng.normal(scale=0.2, size=(n_cams, 3)))
    t = -np.einsum("nij,nj->ni", R, C)
    intr = np.stack([rng.uniform(600.0, 1500.0, n_cams), rng.normal(0, 0.05, n_cams),
                     rng.normal(0, 0.01, n_cams)], 1)
    X = rng.uniform(-1, 1, (n_points, 3)) * [1.0, 1.0, 0.4]
    k = track_lengths(rng, n_points, n_obs, n_cams)
    base = rng.integers(0, n_cams, n_points)
    stride = np.minimum(rng.integers(1, 4, n_points), n_cams // k)
    point = np.repeat(np.arange(n_points), k)
    j = np.arange(n_obs) - np.repeat(np.cumsum(k) - k, k)
    cam = (base[point] + stride[point] * j) % n_cams
    x = project(R, t, intr, X, cam, point) + rng.normal(scale=noise_px, size=(n_obs, 2))
    out = np.nonzero(rng.random(n_obs) < outlier_share)[0]
    x[out] += rng.uniform(-30, 30, (len(out), 2))
    R0 = _rodrigues(rng.normal(scale=2e-3, size=(n_cams, 3))) @ R
    C0 = C + rng.normal(scale=0.01, size=C.shape)
    t0 = -np.einsum("nij,nj->ni", R0, C0)
    intr0 = np.stack([intr[:, 0] * (1 + rng.normal(0, 0.005, n_cams)),
                      np.zeros(n_cams), np.zeros(n_cams)], 1)
    X0 = X + rng.normal(scale=0.01, size=X.shape)
    if seed is None:
        return BALProblem(cam, point, x, R0, t0, intr0, X0, R, t, intr, X)
    order = np.random.default_rng(seed % 2 ** 64)
    pc, pp = order.permutation(n_cams), order.permutation(n_points)
    cam, point = pc[cam], pp[point]
    obs = np.argsort(point, kind="stable")
    inv_c, inv_p = np.argsort(pc), np.argsort(pp)
    return BALProblem(cam[obs], point[obs], x[obs], R0[inv_c], t0[inv_c], intr0[inv_c],
                      X0[inv_p], R[inv_c], t[inv_c], intr[inv_c], X[inv_p])
