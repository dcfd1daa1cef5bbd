"""FAST corner detector and pyramidal KLT tracking (counterpart:
openmvg_tpu/ops/fast.py).

Reference parity: features/fast/fast_detector.hpp (FAST-9/16 segment test
over the 16-pixel Bresenham circle, third_party/fast) as the VO sample
uses it; the KLT tracker follows software/VO's tracker interface.

The segment test compares all 16 circle offsets as shifted views of the
image; the score is their sum of absolute differences, added in circle
order; corners are kept by 3x3 non-maximum suppression and a stable
descending sort (ties to the lower flat index, as lax.top_k).  KLT runs
every point at once: 7x7 windows gathered per point, 10 Gauss-Newton
steps of a closed-form 2x2 solve per pyramid level, in float32.
"""

import numpy as np
import torch

from openmvg_torch.ops.akaze import gradient, top_k_stable
from openmvg_torch.ops.sift import _bilinear, _blur

# 16-point Bresenham circle of radius 3, (dy, dx), clockwise from the top
# (fast_detector.hpp offsets)
_CIRCLE = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
])


def fast_detect(img, threshold=0.08, arc=9, max_corners=2048):
    """FAST-9 corners of an (H, W) float image in [0, 1].

    Returns (xy (K, 2) float32, score (K,), valid (K,)) on img's device."""
    H, W = img.shape
    pad = 3
    c = img[pad:H - pad, pad:W - pad]
    ring = [img[pad + dy:H - pad + dy, pad + dx:W - pad + dx] for dy, dx in _CIRCLE]
    B = torch.stack([n > c + threshold for n in ring])        # (16, h, w)
    D = torch.stack([n < c - threshold for n in ring])
    # a contiguous (circular) arc of at least `arc` pixels: every start
    Bc = torch.cat([B, B[:arc - 1]])
    Dc = torch.cat([D, D[:arc - 1]])
    run_b = torch.zeros_like(B[0])
    run_d = torch.zeros_like(D[0])
    for s in range(16):
        run_b |= Bc[s:s + arc].all(0)
        run_d |= Dc[s:s + arc].all(0)
    corner = run_b | run_d
    sad = torch.zeros_like(c)
    for n in ring:
        sad = sad + (n - c).abs()
    score = torch.where(corner, sad, torch.zeros_like(sad))
    h, w = score.shape
    sp = torch.nn.functional.pad(score, (1, 1, 1, 1))
    nms = torch.ones_like(corner)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == dx == 0:
                continue
            nms &= score >= sp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    score = torch.where(nms, score, torch.zeros_like(score))
    vals, flat = top_k_stable(score.reshape(-1), min(max_corners, score.numel()))
    xy = torch.stack([flat % w + pad, flat // w + pad], -1).to(torch.float32)
    return xy, vals, vals > 0


def _track_level(I0, I1, p0, d, oy, ox, n_iter):
    """Lucas-Kanade on one level for every point: p0 (N, 2) in the level's
    pixels, d (N, 2) the displacement carried from the coarser level."""
    gy, gx = gradient(I0)
    sy = p0[:, 1:2] + oy
    sx = p0[:, 0:1] + ox
    t = _bilinear(I0, sy, sx)
    Ix = _bilinear(gx, sy, sx)
    Iy = _bilinear(gy, sy, sx)
    sxx, sxy, syy = (Ix * Ix).sum(-1), (Ix * Iy).sum(-1), (Iy * Iy).sum(-1)
    det_g = sxx * syy - sxy * sxy                     # det G
    a, b_, c_ = sxx + 1e-6, sxy, syy + 1e-6          # G + 1e-6 I
    det_r = a * c_ - b_ * b_
    dloc = d
    for _ in range(n_iter):
        e = t - _bilinear(I1, sy + dloc[:, 1:2], sx + dloc[:, 0:1])
        b0, b1 = (e * Ix).sum(-1), (e * Iy).sum(-1)
        step = torch.stack([c_ * b0 - b_ * b1, a * b1 - b_ * b0], -1) / det_r[:, None]
        dloc = dloc + step
    ok = det_g > 1e-7
    return torch.where(ok[:, None], dloc, d), ok


def klt_track(img0, img1, pts, window=7, n_iter=10, n_levels=3):
    """Pyramidal Lucas-Kanade: track pts (N, 2) [x y] from img0 to img1
    ((H, W) float32 tensors on one device).  Returns (new_pts (N, 2), ok (N,))."""
    pyr0, pyr1 = [img0], [img1]
    for _ in range(n_levels - 1):
        pyr0.append(_blur(pyr0[-1], 1.0)[::2, ::2])
        pyr1.append(_blur(pyr1[-1], 1.0)[::2, ::2])
    half = window // 2
    off = torch.arange(-half, half + 1, dtype=torch.float32, device=img0.device)
    OY, OX = torch.meshgrid(off, off, indexing="ij")
    oy, ox = OY.reshape(-1), OX.reshape(-1)
    d = torch.zeros_like(pts)
    ok_all = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    for lv in range(n_levels - 1, -1, -1):
        d, ok = _track_level(pyr0[lv], pyr1[lv], pts / 2.0 ** lv, d, oy, ox, n_iter)
        ok_all &= ok
        if lv > 0:
            d = d * 2.0
    new_pts = pts + d
    H, W = img1.shape
    inside = ((new_pts[:, 0] >= half) & (new_pts[:, 0] < W - half)
              & (new_pts[:, 1] >= half) & (new_pts[:, 1] < H - half))
    return new_pts, ok_all & inside
