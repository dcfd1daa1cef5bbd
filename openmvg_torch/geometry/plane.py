"""Robust 3D plane estimation (counterpart: openmvg_tpu/geometry/plane.py;
openMVG geometry/plane_estimation_kernel.hpp): the 3-point half-plane
solver, the point-to-plane distance and the bearing-to-normal angular
error, fitted with ops/ransac.max_consensus.

A plane is (normal, d) with unit `normal` and n.x + d = 0 (Hessian normal
form), plus the centroid of its fitting sample, which the angular error
measures from.  Every function batches over leading dimensions.
"""

import math
from typing import NamedTuple

import torch

from openmvg_torch.ops import ransac


class Plane(NamedTuple):
    normal: torch.Tensor    # (..., 3) unit normal
    d: torch.Tensor         # (...,) offset: n.x + d = 0
    centroid: torch.Tensor  # (..., 3) mean of the fitting sample


def plane_from_3_points(pts):
    """(..., 3, 3) sample -> (Plane, valid); valid is False for
    (near-)collinear samples."""
    a, b, c = pts[..., 0, :], pts[..., 1, :], pts[..., 2, :]
    n = torch.linalg.cross(b - a, c - a)
    norm = torch.linalg.vector_norm(n, dim=-1)
    n = n / torch.clamp(norm, min=1e-12)[..., None]
    return Plane(n, -(n * a).sum(-1), (a + b + c) / 3.0), norm > 1e-12


def abs_distance(plane, x):
    """|n.x + d| (AbsDistanceError); plane (...), x (..., 3)."""
    return ((plane.normal * x).sum(-1) + plane.d).abs()


def abs_angular_error(plane, x):
    """|angle(bearing, normal) - pi/2| (AbsAngularError), the bearing
    running from the sample centroid to x."""
    b = x - plane.centroid
    b = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True), min=1e-12)
    cosang = torch.clamp((b * plane.normal).sum(-1), -1.0, 1.0)
    return (torch.arccos(cosang) - math.pi / 2.0).abs()


def fit_plane_max_consensus(generator, points, threshold, n_samples=256, angular=False,
                            idx=None):
    """Robust plane of (N, 3) points (HalfPlaneKernel + MaxConsensus):
    threshold bounds the distance (radians when angular).  idx, when given,
    is the (n_samples, 3) sample table.  Returns (Plane, inliers (N,),
    score)."""
    err_fn = abs_angular_error if angular else abs_distance

    def fit(sub):
        plane, ok = plane_from_3_points(sub[0][:, None])
        return plane, ok

    def error(plane, data):
        e = err_fn(Plane(*(f[:, None] for f in plane)), data[0][None])
        return e * e

    valid = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    return ransac.max_consensus(generator, fit, error, (points,), valid, 3,
                                threshold * threshold, n_samples=n_samples, idx=idx)
