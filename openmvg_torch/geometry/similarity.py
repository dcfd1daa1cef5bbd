"""7-DoF similarity transforms, Umeyama alignment (counterpart:
openmvg_tpu/geometry/similarity.py; geometry/rigid_transformation3D_srt.hpp
FindRTS)."""

from typing import NamedTuple

import torch

from openmvg_torch.ops import linalg


class Similarity(NamedTuple):
    """x' = scale * R @ x + t."""

    scale: torch.Tensor  # (...,)
    R: torch.Tensor      # (..., 3, 3)
    t: torch.Tensor      # (..., 3)

    def apply(self, X):
        """Point sets (..., N, 3) under the batch of transforms (...)."""
        return (self.scale[..., None, None] * (X @ self.R.transpose(-1, -2))
                + self.t[..., None, :])


def find_rts(x, y, weights=None):
    """Least-squares similarity mapping points x -> y, (..., N, 3) each
    (Umeyama's closed form); weights (..., N) optional."""
    if weights is None:
        weights = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    w = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-12)
    mu_x = (x * w[..., None]).sum(-2)
    mu_y = (y * w[..., None]).sum(-2)
    xc = x - mu_x[..., None, :]
    yc = y - mu_y[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", w, yc, xc)
    var_x = (w * (xc * xc).sum(-1)).sum(-1)
    U, D, Vt = linalg.svd3(cov)
    det = linalg.det3(U) * linalg.det3(Vt)
    S = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = (U * S[..., None, :]) @ Vt
    scale = (D * S).sum(-1) / torch.clamp(var_x, min=1e-12)
    t = mu_y - scale[..., None] * torch.einsum("...ij,...j->...i", R, mu_x)
    return Similarity(scale=scale, R=R, t=t)


def align_poses_rts(centers_est, centers_gt):
    """Similarity aligning estimated camera centres to ground truth (the
    evalQuality protocol, tools_precisionEvaluationToGt.hpp:21-60)."""
    return find_rts(centers_est, centers_gt)
