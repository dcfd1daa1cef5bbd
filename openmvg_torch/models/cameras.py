"""Batched camera models — the six openMVG intrinsic kinds (counterpart:
openmvg_tpu/models/cameras.py).

A camera is (kind, width, height, params[8]) with params =
[f, ppx, ppy, d0..d4]; kind ids mirror openMVG's EINTRINSIC
(Camera_Common.hpp:39-49).  The projection functions take tensors that
broadcast over leading dimensions: every kind's branch is computed and
the result selected with torch.where, as the reference does, so one call
serves a mixed batch and stays differentiable under torch.func.

  cam2ima / ima2cam   Camera_Pinhole.hpp, Camera_Spherical.hpp:89
  add_disto           radial K1/K3 and Brown T2 (one additive formula),
                      fisheye (Camera_Pinhole_Fisheye.hpp:86-105)
  remove_disto        radial by bisection (Camera_Pinhole_Radial.hpp:38-70,
                      48 halvings), Brown by 20 fixed-point steps, fisheye
                      by 10 (Camera_Pinhole_Fisheye.hpp:112-136)
  project_cam, bearing, residual
"""

import math
from typing import NamedTuple

import numpy as np
import torch

PINHOLE = 1
PINHOLE_RADIAL_K1 = 2
PINHOLE_RADIAL_K3 = 3
PINHOLE_BROWN = 4
PINHOLE_FISHEYE = 5
SPHERICAL = 7

KIND_NAMES = {
    PINHOLE: "pinhole",
    PINHOLE_RADIAL_K1: "pinhole_radial_k1",
    PINHOLE_RADIAL_K3: "pinhole_radial_k3",
    PINHOLE_BROWN: "pinhole_brown_t2",
    PINHOLE_FISHEYE: "fisheye",
    SPHERICAL: "spherical",
}
KIND_FROM_NAME = {v: k for k, v in KIND_NAMES.items()}

# optimizable parameters per kind (getParams() length)
N_PARAMS = {
    PINHOLE: 3,
    PINHOLE_RADIAL_K1: 4,
    PINHOLE_RADIAL_K3: 6,
    PINHOLE_BROWN: 8,
    PINHOLE_FISHEYE: 7,
    SPHERICAL: 0,
}
MAX_PARAMS = 8


class Cameras(NamedTuple):
    """A batch of intrinsics keyed by dense intrinsic id (numpy arrays)."""

    kind: np.ndarray    # (I,) int32 EINTRINSIC value
    width: np.ndarray   # (I,) float
    height: np.ndarray  # (I,) float
    params: np.ndarray  # (I, 8) float: [f, ppx, ppy, d0, d1, d2, d3, d4]


def make_pinhole(width, height, focal, ppx=None, ppy=None, kind=PINHOLE, disto=()):
    """Single-camera record (host side)."""
    params = np.zeros(MAX_PARAMS)
    params[0:3] = [focal, width / 2.0 if ppx is None else ppx,
                   height / 2.0 if ppy is None else ppy]
    disto = np.asarray(disto, np.float64)
    params[3:3 + disto.size] = disto
    return Cameras(kind=np.array([kind], np.int32), width=np.array([width], np.float64),
                   height=np.array([height], np.float64), params=params[None])


def K_matrix_np(params):
    """(..., >=3) pinhole params -> (..., 3, 3) calibration matrix."""
    params = np.asarray(params)
    K = np.zeros(params.shape[:-1] + (3, 3), params.dtype)
    K[..., 0, 0] = params[..., 0]
    K[..., 0, 2] = params[..., 1]
    K[..., 1, 1] = params[..., 0]
    K[..., 1, 2] = params[..., 2]
    K[..., 2, 2] = 1.0
    return K


def K_matrix(params):
    """Tensor twin of K_matrix_np."""
    f, ppx, ppy = params[..., 0], params[..., 1], params[..., 2]
    z, o = torch.zeros_like(f), torch.ones_like(f)
    return torch.stack([torch.stack([f, z, ppx], -1), torch.stack([z, f, ppy], -1),
                        torch.stack([z, z, o], -1)], -2)


def _is(kind, k):
    return (kind == k)[..., None]


# ---------------------------------------------------------------------------
# cam <-> image plane
# ---------------------------------------------------------------------------

def cam2ima(kind, params, width, height, p):
    """Normalized camera-plane points (..., 2) -> pixels."""
    pin = params[..., 0:1] * p + params[..., 1:3]
    size = torch.maximum(width, height)[..., None]
    sph = p * size + torch.stack([width, height], -1) * 0.5
    return torch.where(_is(kind, SPHERICAL), sph, pin)


def ima2cam(kind, params, width, height, p):
    """Pixels (..., 2) -> normalized camera plane."""
    pin = (p - params[..., 1:3]) / params[..., 0:1]
    size = torch.maximum(width, height)[..., None]
    sph = (p - torch.stack([width, height], -1) * 0.5) / size
    return torch.where(_is(kind, SPHERICAL), sph, pin)


# ---------------------------------------------------------------------------
# distortion
# ---------------------------------------------------------------------------

def _brown_disto_term(params, p):
    """Additive Brown T2 term; with t1 = t2 = 0 it is the radial model."""
    k1, k2, k3, t1, t2 = (params[..., 3 + i] for i in range(5))
    x, y = p[..., 0], p[..., 1]
    r2 = x * x + y * y
    k_diff = k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    t_x = t2 * (r2 + 2 * x * x) + 2 * t1 * x * y
    t_y = t1 * (r2 + 2 * y * y) + 2 * t2 * x * y
    return torch.stack([x * k_diff + t_x, y * k_diff + t_y], -1)


def _fisheye_add_disto(params, p):
    k1, k2, k3, k4 = (params[..., 3 + i] for i in range(4))
    eps = 1e-8
    r = torch.hypot(p[..., 0], p[..., 1])
    theta = torch.arctan(r)
    th2 = theta * theta
    theta_dist = theta * (1 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4))))
    cdist = torch.where(r > eps, theta_dist / torch.clamp(r, min=eps), torch.ones_like(r))
    return p * cdist[..., None]


def add_disto(kind, params, p):
    """Apply the distortion field to normalized camera points (..., 2)."""
    brown = p + _brown_disto_term(params, p)
    fish = _fisheye_add_disto(params, p)
    has_poly = ((kind == PINHOLE_RADIAL_K1) | (kind == PINHOLE_RADIAL_K3)
                | (kind == PINHOLE_BROWN))[..., None]
    out = torch.where(has_poly, brown, p)
    return torch.where(_is(kind, PINHOLE_FISHEYE), fish, out)


def _radial_remove_disto(params, p, n_bisect=48):
    """Solve r_u2 (1 + k1 r_u2 + k2 r_u2^2 + k3 r_u2^3)^2 = r_d2 by a
    bracket grown 10 times, then n_bisect halvings."""
    k1, k2, k3 = params[..., 3], params[..., 4], params[..., 5]
    r_d2 = (p * p).sum(-1)

    def functor(r2):
        c = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        return r2 * c * c

    ub = torch.clamp(r_d2, min=1e-12)
    for _ in range(10):
        ub = torch.where(functor(ub) < r_d2, ub * 2.0, ub)
    lb = torch.zeros_like(ub)
    for _ in range(n_bisect):
        mid = 0.5 * (lb + ub)
        high = functor(mid) > r_d2
        lb, ub = torch.where(high, lb, mid), torch.where(high, mid, ub)
    r_u2 = 0.5 * (lb + ub)
    scale = torch.where(r_d2 > 1e-16, torch.sqrt(r_u2 / torch.clamp(r_d2, min=1e-16)),
                        torch.ones_like(r_d2))
    return p * scale[..., None]


def _brown_remove_disto(params, p, n_iter=20):
    p_u = p
    for _ in range(n_iter):
        p_u = p - _brown_disto_term(params, p_u)
    return p_u


def _fisheye_remove_disto(params, p, n_iter=10):
    k1, k2, k3, k4 = (params[..., 3 + i] for i in range(4))
    eps = 1e-8
    theta_dist = torch.hypot(p[..., 0], p[..., 1])
    theta = theta_dist
    for _ in range(n_iter):
        th2 = theta * theta
        theta = theta_dist / (1 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4))))
    scale = torch.where(theta_dist > eps, torch.tan(theta) / torch.clamp(theta_dist, min=eps),
                        torch.ones_like(theta))
    return p * scale[..., None]


def remove_disto(kind, params, p):
    """Invert the distortion field on normalized camera points (..., 2).
    A kind's iterative inverse runs only when the batch holds that kind
    (the others would be selected away): the filters call this on every
    observation of a scene, mostly of one kind."""
    out = p
    is_radial = ((kind == PINHOLE_RADIAL_K1) | (kind == PINHOLE_RADIAL_K3))[..., None]
    if bool(is_radial.any()):
        out = torch.where(is_radial, _radial_remove_disto(params, p), out)
    if bool((kind == PINHOLE_BROWN).any()):
        out = torch.where(_is(kind, PINHOLE_BROWN), _brown_remove_disto(params, p), out)
    if bool((kind == PINHOLE_FISHEYE).any()):
        out = torch.where(_is(kind, PINHOLE_FISHEYE), _fisheye_remove_disto(params, p), out)
    return out


# ---------------------------------------------------------------------------
# projection / bearing
# ---------------------------------------------------------------------------

def clamp_depth(z, eps=1e-12):
    """z with |z| < eps replaced by +-eps (its sign kept)."""
    e = torch.full_like(z, eps)
    return torch.where(z.abs() < eps, torch.where(z < 0, -e, e), z)


def project_cam(kind, params, width, height, Xc, ignore_distortion=False):
    """Camera-frame points (..., 3) -> pixels (..., 2)."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zs = clamp_depth(z)
    p = torch.stack([x / zs, y / zs], -1)
    if not ignore_distortion:
        p = add_disto(kind, params, p)
    pin = cam2ima(kind, params, width, height, p)
    lon = torch.atan2(x, z)
    lat = torch.atan2(-y, torch.hypot(x, z))
    sph_cam = torch.stack([lon / (2 * math.pi), -lat / (2 * math.pi)], -1)
    sph = cam2ima(kind, params, width, height, sph_cam)
    return torch.where(_is(kind, SPHERICAL), sph, pin)


def bearing(kind, params, width, height, pix):
    """Pixels (..., 2) -> unit bearings (..., 3)."""
    uv = ima2cam(kind, params, width, height, pix)
    und = remove_disto(kind, params, uv)
    h = torch.cat([und, torch.ones_like(und[..., :1])], -1)
    pin = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)
    lon = uv[..., 0] * (2 * math.pi)
    lat = -uv[..., 1] * (2 * math.pi)
    sph = torch.stack([torch.cos(lat) * torch.sin(lon), -torch.sin(lat),
                       torch.cos(lat) * torch.cos(lon)], -1)
    return torch.where(_is(kind, SPHERICAL), sph, pin)


def residual(kind, params, width, height, Xc, observed):
    """project(Xc) - observed, (..., 2) (Camera_Intrinsics.hpp:208).  A
    SPHERICAL view's x difference is taken modulo one turn, max(w, h)
    pixels, into [-turn / 2, turn / 2]: a point on the panorama's seam is
    then a few pixels off, not a whole image width (openMVG and the
    reference subtract the pixels as they are)."""
    d = project_cam(kind, params, width, height, Xc) - observed
    turn = torch.maximum(torch.as_tensor(width), torch.as_tensor(height))
    dx = d[..., 0] - turn * torch.round(d[..., 0] / turn)
    return torch.where(_is(kind, SPHERICAL), torch.stack([dx, d[..., 1]], -1), d)


def image_plane_to_camera_plane_error(kind, params, width, height, value):
    """Pixel threshold -> camera plane: value / f, or value / max(w, h)
    for a spherical camera."""
    pin = value / params[..., 0]
    sph = value / torch.maximum(width, height)
    return torch.where(kind == SPHERICAL, sph, pin)


def camera_rows(cams: Cameras, intr_ids, dtype, device):
    """Per-row (kind, params, width, height) tensors of `cams` at
    intr_ids (numpy), the argument tuple of project_cam and bearing."""
    ids = np.asarray(intr_ids)
    return (torch.as_tensor(np.asarray(cams.kind, np.int32)[ids], device=device),
            torch.as_tensor(np.asarray(cams.params, np.float64)[ids], dtype=dtype, device=device),
            torch.as_tensor(np.asarray(cams.width, np.float64)[ids], dtype=dtype, device=device),
            torch.as_tensor(np.asarray(cams.height, np.float64)[ids], dtype=dtype, device=device))
