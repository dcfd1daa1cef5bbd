"""Batched SO(3) utilities: axis-angle <-> rotation matrix, projections
(counterpart: openmvg_tpu/geometry/so3.py).

Every function broadcasts over leading batch dimensions; the Taylor
branches around theta = 0 keep torch.func Jacobians finite.
"""

import math

import torch

from openmvg_torch.ops import linalg

_EPS = 1e-8


def skew(w):
    """(..., 3) -> (..., 3, 3) cross-product matrix [w]_x."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def _coeffs(w):
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS ** 2))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS ** 2))
    return a, b


def expmap(w):
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues)."""
    a, b = _coeffs(w)
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def rotate(w, v):
    """R(w) v without forming R: v + a (w x v) + b (w x (w x v))
    (ceres AngleAxisRotatePoint)."""
    a, b = _coeffs(w)
    w = w.expand(torch.broadcast_shapes(w.shape, v.shape))
    wxv = torch.cross(w, v.expand(w.shape), dim=-1)
    wxwxv = torch.cross(w, wxv, dim=-1)
    return v + a[..., None] * wxv + b[..., None] * wxwxv


def logmap(R):
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3); stable near 0,
    about sqrt(eps) accurate near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1) * 0.5
    small = theta < 1e-5
    near_pi = theta > math.pi - 1e-3
    scale = torch.where(small, 1.0 + theta * theta / 6.0,
                        theta / torch.clamp(torch.sin(theta), min=1e-12))
    w_generic = v * scale[..., None]
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    denom = torch.clamp(1.0 - cos_t, min=1e-12)
    axis = torch.sqrt(torch.clamp((diag - cos_t[..., None]) / denom[..., None], min=0.0))
    sign = torch.where(v >= 0, 1.0, -1.0).to(R.dtype)
    w_pi = axis * sign * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def project_to_so3(M):
    """Nearest rotation to (..., 3, 3) M (ClosestSVDRotationMatrix)."""
    U, _, Vt = linalg.svd3(M)
    det = linalg.det3(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    return (U * D[..., None, :]) @ Vt


def rotation_angle_deg(R):
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.rad2deg(torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)))


def relative_rotation_angle_deg(Ra, Rb):
    """Angle of Ra Rb^T in degrees."""
    return rotation_angle_deg(Ra @ Rb.transpose(-1, -2))


def quat_to_rot(q):
    """Unit quaternion (..., 4) wxyz -> rotation matrix (..., 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
