"""LIOP: the Local Intensity Order Pattern descriptor (Wang, Fan, Wu,
ICCV'11) (counterpart: openmvg_tpu/ops/liop.py).

Reference parity: features/liop/liop_descriptor.{hpp,cpp} — a 31 px
scale-normalised patch inside a 37 px sampling window, Gaussian sigma 1.2,
the 4-neighbour intensity-order pattern (24 permutations) at ring radius
6, 6 gray-quantile regions, 144-d, normalised.  The reference's documented
deviation is kept: equal grays at a quantile fence are split by sorted
rank.

Every keypoint at once: one (K, 37, 37) patch gather, a zero-padded
separable blur (the kernel is symmetric, so correlation is jnp.convolve's
'same' convolution), stable argsorts for the patterns and the ranks, and
the histogram as an integer bincount (each in-disk pixel counts one).  The
ring's angles are rounded once from float64 and every other float step is
a single rounding of a plain product or sum, the blur's taps added one by
one, so the card and the CPU order the same grays and count the same
histograms; only the final normalisation may round apart.
"""

import math

import numpy as np
import torch

from openmvg_torch.ops.dipole import as_f32, bilinear_clamped

PATCH = 37            # outPatchWidth (31 + 6)
RADIUS = PATCH // 2   # 18
IN_RADIUS = 15        # scalePatchWidth / 2
LIOP_NUM = 4
REGION_NUM = 6
RING_RADIUS = 6.0
DIM = 24 * REGION_NUM  # 144


def _gaussian_kernel1d(sigma):
    r = int(math.ceil(3 * sigma))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur_patches(p, k):
    """'same' zero-padded separable convolution of (K, P, P) patches, the
    taps added in order."""
    r = (len(k) - 1) // 2

    def along(x, dim):
        xp = torch.nn.functional.pad(x, (r, r) if dim == 2 else (0, 0, r, r))
        n = x.shape[dim]
        acc = float(k[0]) * xp.narrow(dim, 0, n)
        for j in range(1, len(k)):
            acc = acc + float(k[j]) * xp.narrow(dim, j, n)
        return acc

    return along(along(p, 2), 1)


def _ring_samples(device):
    """Bilinear corner indices and weights of the 4 ring samples around
    every patch pixel, in the patch's frame.  atan2, sin and cos are taken
    in float64 and rounded once, so that the card and the CPU place the
    samples alike (in float32 they may differ by an ulp, enough to flip
    two nearly equal grays of an order pattern)."""
    g = np.mgrid[-RADIUS:RADIUS + 1, -RADIUS:RADIUS + 1]
    dy, dx = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in g)
    ori = torch.atan2(dy.double(), dx.double()).float()
    ori = torch.where((ori - math.pi).abs() < 1e-7, torch.full_like(ori, -math.pi), ori)
    ks = torch.arange(LIOP_NUM, dtype=torch.float32, device=device) * (2 * math.pi / LIOP_NUM)
    ang = (ori[..., None] + ks).double()                             # (P, P, 4)
    sy = dy[..., None] + RING_RADIUS * torch.sin(ang).float() + RADIUS
    sx = dx[..., None] + RING_RADIUS * torch.cos(ang).float() + RADIUS
    ok_b = (sx >= 0) & (sy >= 0) & (sx <= PATCH - 1) & (sy <= PATCH - 1)
    y0 = torch.clamp(torch.floor(sy), 0, PATCH - 1).to(torch.int64)
    x0 = torch.clamp(torch.floor(sx), 0, PATCH - 1).to(torch.int64)
    return (dy, dx, ok_b, y0, x0, torch.clamp(y0 + 1, max=PATCH - 1),
            torch.clamp(x0 + 1, max=PATCH - 1), sy - y0, sx - x0)


def liop_describe(image, xy, scale, device=None):
    """Batched LIOP descriptors.

    image (H, W) gray (any positive range), xy (K, 2) pixel coordinates,
    scale (K,).  Runs on `device` (default: the image's); returns (K, 144)
    float32."""
    dev = device if device is not None else getattr(image, "device", "cpu")
    image, xy, scale = (as_f32(a, dev) for a in (image, xy, scale))
    K = xy.shape[0]
    H, W = image.shape
    dy, dx, ok_b, y0, x0, y1, x1, fy, fx = _ring_samples(dev)
    in_disk = dy * dy + dx * dx <= RADIUS * RADIUS
    ys = dy * scale[:, None, None] + xy[:, 1, None, None]
    xs = dx * scale[:, None, None] + xy[:, 0, None, None]
    flag = in_disk & (ys >= 0) & (ys <= H - 1) & (xs >= 0) & (xs <= W - 1)   # (K, P, P)
    patch = torch.where(flag, bilinear_clamped(image, ys, xs), torch.zeros_like(ys))
    patch_s = _blur_patches(patch, _gaussian_kernel1d(1.2))

    # ring samples at radius 6 around every in-disk pixel
    inner = flag & (dy * dy + dx * dx <= IN_RADIUS * IN_RADIUS)
    corners_ok = flag[:, y0, x0] & flag[:, y0, x1] & flag[:, y1, x0] & flag[:, y1, x1]
    gray = (patch_s[:, y0, x0] * (1 - fy) * (1 - fx) + patch_s[:, y0, x1] * (1 - fy) * fx
            + patch_s[:, y1, x0] * fy * (1 - fx) + patch_s[:, y1, x1] * fy * fx)  # (K, P, P, 4)
    ok_all = inner & (ok_b & corners_ok).all(-1)

    # pattern id: the lexicographic (Lehmer) rank of the stable argsort
    idx = torch.argsort(gray, dim=-1, stable=True)
    later = torch.triu(torch.ones((LIOP_NUM, LIOP_NUM), dtype=torch.bool, device=dev), 1)
    lehmer = ((idx[..., None, :] < idx[..., :, None]) & later).sum(-1)
    fact = torch.tensor([6, 2, 1, 0], device=dev)
    pattern = (lehmer * fact).sum(-1).reshape(K, -1)                # (K, P*P) in [0, 23]

    # quantile regions over the valid pixels ranked by centre gray
    flat_ok = ok_all.reshape(K, -1)
    flat_gray = torch.where(flat_ok, patch_s.reshape(K, -1), torch.full_like(flat_ok, math.inf,
                                                                             dtype=torch.float32))
    count = flat_ok.sum(-1)
    order = torch.argsort(flat_gray, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=dev).expand_as(order))
    fences = count[:, None] * torch.arange(1, REGION_NUM + 1, device=dev) // REGION_NUM - 1
    region = torch.clamp((rank[:, :, None] > fences[:, None, :]).sum(-1), 0, REGION_NUM - 1)
    bins = region * 24 + pattern + DIM * torch.arange(K, device=dev)[:, None]
    bins = torch.where(flat_ok, bins, torch.full_like(bins, K * DIM))
    desc = torch.bincount(bins.reshape(-1), minlength=K * DIM + 1)[:K * DIM]
    desc = desc.reshape(K, DIM).to(torch.float32)
    desc = torch.where((count >= REGION_NUM)[:, None], desc, torch.zeros_like(desc))
    norm = torch.sqrt((desc * desc).sum(-1, keepdim=True))
    return desc / torch.clamp(norm, min=1e-12)
