"""Batched SE(3) poses stored as (R, C) (counterpart:
openmvg_tpu/geometry/pose.py; openMVG geometry/pose3.hpp): world->camera
rotation and camera centre, x_cam = R (x_world - C), t = -R C."""

from typing import NamedTuple

import torch


class Pose(NamedTuple):
    R: torch.Tensor  # (..., 3, 3)
    C: torch.Tensor  # (..., 3)

    @property
    def t(self):
        return -torch.einsum("...ij,...j->...i", self.R, self.C)

    def apply(self, X):
        return torch.einsum("...ij,...j->...i", self.R, X - self.C)

    def inverse(self):
        return Pose(R=self.R.transpose(-1, -2),
                    C=-torch.einsum("...ij,...j->...i", self.R, self.C))

    def compose(self, other):
        """self * other (other applied first), pose3.hpp operator*."""
        return Pose(R=self.R @ other.R,
                    C=other.C + torch.einsum("...ij,...j->...i",
                                             other.R.transpose(-1, -2), self.C))


def pose_from_Rt(R, t):
    return Pose(R=R, C=-torch.einsum("...ji,...j->...i", R, t))


def relative_pose(pose_a: Pose, pose_b: Pose) -> Pose:
    """Pose of b relative to a: x_b = R_rel (x_a - C_rel)."""
    R_rel = pose_b.R @ pose_a.R.transpose(-1, -2)
    C_rel = torch.einsum("...ij,...j->...i", pose_a.R, pose_b.C - pose_a.C)
    return Pose(R=R_rel, C=C_rel)
