"""Spherical (equirectangular) image utilities (counterpart:
openmvg_tpu/ops/spherical.py).

Reference parity: spherical/cubic_image_sampler.hpp:57 (equirectangular ->
6-face cubemap resampling with per-face pinhole cameras) and
spherical/image_resampling.hpp:20 (a pose-rotated pinhole view resampled
from an equirectangular panorama); CLI main_openMVGSpherical2Cubic.cpp.

Every output view of a call is one batched bilinear gather on the
panorama's device, in float32: x wraps around the panorama, y clamps.
"""

import math

import numpy as np
import torch

from openmvg_torch.utils.hostmath import expmap_np

# face order of GetCubicRotations (cubic_image_sampler.hpp): front, right,
# back, left, up, down, as rotations applied to bearings
_FACE_ROT = [
    (0.0, 0.0, 0.0),
    (0.0, -np.pi / 2, 0.0),
    (0.0, np.pi, 0.0),
    (0.0, np.pi / 2, 0.0),
    (-np.pi / 2, 0.0, 0.0),
    (np.pi / 2, 0.0, 0.0),
]


def _bilinear_wrap(img, y, x):
    """img (H, W, C) at float y/x (any shape S) -> (*S, C); x wraps, y
    clamps to the rows."""
    H, W = img.shape[:2]
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    xf = torch.floor(x)
    x0 = torch.remainder(xf.to(torch.int64), W)
    x1 = torch.remainder(x0 + 1, W)
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
    fx = (x - xf)[..., None]
    return (img[y0, x0] * (1 - fy) * (1 - fx) + img[y0, x1] * (1 - fy) * fx
            + img[y0 + 1, x0] * fy * (1 - fx) + img[y0 + 1, x1] * fy * fx)


def sample_pinholes_from_equirect(pano, Rs, focal, out_size):
    """Pinhole views of an equirectangular panorama (H, W[, C]) tensor, one
    per world->camera rotation of Rs (B, 3, 3): (B, n, n[, C]) float32."""
    H, W = pano.shape[:2]
    dev = pano.device
    n = out_size
    g = torch.arange(n, dtype=torch.float32, device=dev)
    ys, xs = torch.meshgrid(g, g, indexing="ij")
    d = torch.stack([(xs - n / 2 + 0.5) / focal, (ys - n / 2 + 0.5) / focal,
                     torch.ones_like(xs)], dim=-1)
    R = torch.as_tensor(np.asarray(Rs, np.float32), device=dev)
    dw = torch.einsum("bji,hwj->bhwi", R, d)                     # camera ray -> world
    lon = torch.atan2(dw[..., 0], dw[..., 2])
    lat = torch.atan2(-dw[..., 1], torch.hypot(dw[..., 0], dw[..., 2]))
    u = (lon / (2 * math.pi) + 0.5) * W - 0.5
    v = (0.5 - lat / math.pi) * H - 0.5
    out = _bilinear_wrap(pano.reshape(H, W, -1).to(torch.float32), v, u)
    return out.reshape((R.shape[0], n, n) + tuple(pano.shape[2:]))


def sample_pinhole_from_equirect(pano, R, focal, out_size):
    """One pinhole view (R: world->cam of the virtual camera) of an
    equirectangular panorama (H, W, C) tensor."""
    return sample_pinholes_from_equirect(pano, np.asarray(R)[None], focal, out_size)[0]


def spherical_to_cubic(pano, out_size=None):
    """Equirectangular (H, W[, C]) tensor -> 6 cubemap faces, their
    rotations and focal: (faces (6, S, S[, C]) float32 on pano's device,
    rotations (6, 3, 3), focal), S = H // 2 unless given (90 degree faces)."""
    S = out_size or pano.shape[0] // 2
    focal = S / 2.0
    rots = np.stack([expmap_np(np.array([rx, 0.0, 0.0])) @ expmap_np(np.array([0.0, ry, 0.0]))
                     for rx, ry, _ in _FACE_ROT])
    return sample_pinholes_from_equirect(pano, rots, focal, S), rots, focal
