"""Host-side numpy twins of small device functions (counterpart:
openmvg_tpu/utils/hostmath.py, the helpers the engine takes).

Per-element host math (K matrices, axis-angle conversions, float64
projections for metrics) runs in numpy; they mirror geometry/so3.py and
models/cameras.py with the same Taylor branches.
"""

import numpy as np

from openmvg_torch.models.cameras import K_matrix_np  # noqa: F401

_EPS = 1e-8


def expmap_np(w):
    """Axis-angle (..., 3) -> rotation (..., 3, 3)."""
    w = np.asarray(w, np.float64)
    theta2 = np.sum(w * w, axis=-1)
    theta = np.sqrt(np.maximum(theta2, _EPS ** 2))
    small = theta2 < _EPS
    a = np.where(small, 1.0 - theta2 / 6.0, np.sin(theta) / theta)
    b = np.where(small, 0.5 - theta2 / 24.0,
                 (1.0 - np.cos(theta)) / np.maximum(theta2, _EPS ** 2))
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = np.zeros_like(wx)
    K = np.stack([np.stack([z, -wz, wy], -1), np.stack([wz, z, -wx], -1),
                  np.stack([-wy, wx, z], -1)], -2)
    eye = np.broadcast_to(np.eye(3), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def logmap_np(R):
    """Rotation (..., 3, 3) -> axis-angle (..., 3)."""
    R = np.asarray(R, np.float64)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = np.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos_t)
    v = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], -1) * 0.5
    small = theta < 1e-5
    near_pi = theta > np.pi - 1e-3
    scale = np.where(small, 1.0 + theta * theta / 6.0,
                     theta / np.maximum(np.sin(theta), 1e-12))
    w_generic = v * scale[..., None]
    diag = np.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    denom = np.maximum(1.0 - cos_t, 1e-12)
    axis = np.sqrt(np.maximum((diag - cos_t[..., None]) / denom[..., None], 0.0))
    sign = np.where(v >= 0, 1.0, -1.0)
    return np.where(near_pi[..., None], axis * sign * theta[..., None], w_generic)


def _brown_disto_term_np(params, p):
    k1, k2, k3, t1, t2 = (params[..., 3 + i] for i in range(5))
    x, y = p[..., 0], p[..., 1]
    r2 = x * x + y * y
    k_diff = k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    t_x = t2 * (r2 + 2 * x * x) + 2 * t1 * x * y
    t_y = t1 * (r2 + 2 * y * y) + 2 * t2 * x * y
    return np.stack([x * k_diff + t_x, y * k_diff + t_y], -1)


def project_cam_np(kind, params, width, height, Xc):
    """Float64 projection for all six camera kinds (models/cameras.py
    project_cam, dense-select)."""
    kind = np.asarray(kind, np.int32)
    params = np.asarray(params, np.float64)
    width = np.asarray(width, np.float64)
    height = np.asarray(height, np.float64)
    Xc = np.asarray(Xc, np.float64)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zs = np.where(np.abs(z) < 1e-12, np.where(z < 0, -1e-12, 1e-12), z)
    p = np.stack([x / zs, y / zs], -1)
    brown = p + _brown_disto_term_np(params, p)
    k1, k2, k3, k4 = (params[..., 3 + i] for i in range(4))
    r = np.hypot(p[..., 0], p[..., 1])
    theta = np.arctan(r)
    th2 = theta * theta
    theta_dist = theta * (1 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4))))
    cdist = np.where(r > 1e-8, theta_dist / np.maximum(r, 1e-8), 1.0)
    fish = p * cdist[..., None]
    has_poly = (kind == 2) | (kind == 3) | (kind == 4)
    pd = np.where(has_poly[..., None], brown, p)
    pd = np.where((kind == 5)[..., None], fish, pd)
    pin = params[..., 0:1] * pd + params[..., 1:3]
    lon = np.arctan2(x, z)
    lat = np.arctan2(-y, np.hypot(x, z))
    size = np.maximum(width, height)[..., None]
    sph = (np.stack([lon / (2 * np.pi), -lat / (2 * np.pi)], -1) * size
           + np.stack([width, height], -1) * 0.5)
    return np.where((kind == 7)[..., None], sph, pin)


def residual_np(kind, params, width, height, Xc, observed):
    """Float64 project(Xc) - observed, the x difference of a SPHERICAL view
    wrapped into one turn (models/cameras.py residual)."""
    d = project_cam_np(kind, params, width, height, Xc) - observed
    turn = np.maximum(np.asarray(width, np.float64), np.asarray(height, np.float64))
    dx = d[..., 0] - turn * np.round(d[..., 0] / turn)
    return np.where((np.asarray(kind) == 7)[..., None], np.stack([dx, d[..., 1]], -1), d)
