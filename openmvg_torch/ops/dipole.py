"""DIPOLE: the 20-d luminance-invariant dipole descriptor (counterpart:
openmvg_tpu/ops/dipole.py).

Reference parity: features/dipole/dipole_descriptor.hpp — 12 first-order
samples on a ring of radius lambda1 = 3.5 * scale combined by a fixed 8x12
difference matrix, plus 12 second-order radial differences at lambda1 +-
lambda2 (lambda2 = lambda1 / 2); both blocks L2-normalised (affine
luminance invariance).  The "angular smoothed" variant averages each
sample over 3 ring angles (+-angleSubdiv / 2).

One gather for every keypoint and sample at once, in float32.  The ring's
cosines and sines are taken on the host and every other step is a single
rounding of a plain product, sum or difference (the 8x12 matrix is +-1
pairs, applied as differences), so the card and the CPU give the same
samples bit for bit; only the final normalisations may round apart.
"""

import math

import numpy as np
import torch

# 8x12 first-order dipole combination (dipole_descriptor.hpp:92-100)
_A = np.array([
    [0, 0, 0, 1, 0, 0, 0, 0, 0, -1, 0, 0],
    [0, -1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, -1, 0, 0, 0, 0, 0, 1],
    [0, 0, 0, 0, 1, 0, 0, -1, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, -1],
    [0, -1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0],
    [1, 0, 0, -1, 0, 0, 0, 0, 0, 0, 0, 0],
], np.float32)
_PLUS, _MINUS = np.argmax(_A, 1), np.argmin(_A, 1)


def bilinear_clamped(img, y, x):
    """img (H, W) at float y/x, coordinates clamped into the image first
    (the reference's DIPOLE and LIOP sampler)."""
    H, W = img.shape
    y = torch.clamp(y, 0.0, H - 1.0)
    x = torch.clamp(x, 0.0, W - 1.0)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    fy = y - y0
    fx = x - x0
    return (img[y0, x0] * (1 - fy) * (1 - fx) + img[y0, x1] * (1 - fy) * fx
            + img[y1, x0] * fy * (1 - fx) + img[y1, x1] * fy * fx)


def as_f32(a, device):
    """A numpy array or tensor as a float32 tensor on `device`."""
    return torch.as_tensor(a if torch.is_tensor(a) else np.asarray(a),
                           device=device).to(torch.float32)


def dipole_describe(image, xy, scale, orientation=None, smoothed=True, magnif_factor=3.5,
                    device=None):
    """Batched 20-d dipole descriptors.

    image (H, W) gray; xy (K, 2); scale (K,); orientation (K,) radians (0
    if None).  smoothed=True is the reference default (angular-smoothed
    dipole).  Runs on `device` (default: the image's); returns (K, 20)
    float32."""
    dev = device if device is not None else getattr(image, "device", "cpu")
    image, xy, scale = (as_f32(a, dev) for a in (image, xy, scale))
    K = xy.shape[0]
    ang0 = torch.zeros(K, device=dev) if orientation is None else as_f32(orientation, dev)
    lambda1 = scale * magnif_factor
    lambda2 = lambda1 / 2.0
    sub = 2.0 * math.pi / 12.0
    base = torch.arange(12, dtype=torch.float32, device=dev) * sub
    offs = torch.tensor([0.0, -sub / 2, sub / 2] if smoothed else [0.0], dtype=torch.float32,
                        device=dev)
    # cos and sin in float64, rounded once: the card and the CPU then give
    # the same float32 sample positions (float32 sin and cos may differ by
    # an ulp between the two, which moves a sample and the descriptor)
    ang = (ang0[:, None, None] + base[None, :, None] + offs[None, None, :]).double()
    ca, sa = torch.cos(ang).float(), torch.sin(ang).float()     # (K, 12, S)

    def ring(radius):
        xs = xy[:, 0, None, None] + radius[:, None, None] * ca
        ys = xy[:, 1, None, None] + radius[:, None, None] * sa
        v = bilinear_clamped(image, ys, xs)
        acc = v[..., 0]
        for i in range(1, v.shape[-1]):
            acc = acc + v[..., i]
        return acc / v.shape[-1]                                # (K, 12)

    f1 = ring(lambda1)
    f2 = ring(lambda1 + lambda2) - ring(lambda1 - lambda2)
    b1 = f1[:, _PLUS] - f1[:, _MINUS]                           # f1 @ _A.T, (K, 8)
    b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1, dim=-1, keepdim=True), min=1e-12)
    b2 = f2 / torch.clamp(torch.linalg.vector_norm(f2, dim=-1, keepdim=True), min=1e-12)
    return torch.cat([b1, b2], dim=-1)
