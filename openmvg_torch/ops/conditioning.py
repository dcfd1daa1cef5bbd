"""Point conditioning for DLT-style solvers, HZ 4.4.4 (counterpart:
openmvg_tpu/ops/conditioning.py; multiview/conditioning.cpp)."""

import torch


def preconditioner_from_points(points, mask=None):
    """(..., N, 2) -> (..., 3, 3) variance normaliser (conditioning.cpp
    PreconditionerFromPoints): centroid to the origin, each axis scaled to
    variance 2; an axis of variance below 1e-8 is left as it is."""
    w = (torch.ones(points.shape[:-1], dtype=points.dtype, device=points.device)
         if mask is None else mask.to(points.dtype))
    cnt = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    mean = (points * w[..., None]).sum(-2) / cnt
    var = (((points - mean[..., None, :]) ** 2) * w[..., None]).sum(-2) / cnt
    ok = var >= 1e-8
    factor = torch.where(ok, torch.sqrt(2.0 / torch.clamp(var, min=1e-8)),
                         torch.ones_like(var))
    mean = torch.where(ok, mean, torch.ones_like(mean))
    z = torch.zeros_like(factor[..., 0])
    return torch.stack([torch.stack([factor[..., 0], z, -factor[..., 0] * mean[..., 0]], -1),
                        torch.stack([z, factor[..., 1], -factor[..., 1] * mean[..., 1]], -1),
                        torch.stack([z, z, torch.ones_like(z)], -1)], -2)


def preconditioner_from_size(width, height, dtype=torch.float64, device=None):
    """Image-size normaliser (conditioning.cpp:55-64); width/height scalars
    or (B,) tensors -> (..., 3, 3)."""
    w = torch.as_tensor(width, dtype=dtype, device=device)
    h = torch.as_tensor(height, dtype=dtype, device=device)
    d = 1.0 / torch.sqrt(w * h)
    z = torch.zeros_like(d)
    o = torch.ones_like(d)
    return torch.stack([torch.stack([d, z, -0.5 * w * d], -1),
                        torch.stack([z, d, -0.5 * h * d], -1),
                        torch.stack([z, z, o], -1)], -2)


def apply_transform(T, points):
    """Apply 3x3 T (..., 3, 3) to inhomogeneous (..., N, 2) points."""
    h = points @ T[..., :2, :2].transpose(-1, -2) + T[..., None, :2, 2]
    w = points @ T[..., 2, :2][..., :, None] + T[..., 2, 2][..., None, None]
    return h / w
