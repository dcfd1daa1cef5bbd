"""AKAZE features in PyTorch: FED nonlinear scale space, Hessian detector,
MSURF float descriptor (AKAZE_FLOAT) and MLDB binary descriptor
(AKAZE_MLDB) (counterpart: openmvg_tpu/ops/akaze.py).

Reference parity: features/akaze/AKAZE.cpp:110-283 (nonlinear scale space
by Fast Explicit Diffusion with Perona-Malik g2 conductivity, contrast
factor k = 70th percentile of the gradient magnitude, 4 octaves x 4
sublevels, scale-normalised Hessian determinant detector, threshold
0.001), msurf_descriptor.hpp (4x4 subregions of Gaussian-weighted rotated
gradient sums (dx, dy, |dx|, |dy|) -> 64-d float, L2 normalised),
mldb_descriptor.hpp (binary comparisons of cell means; the reference's
full-patch variant), image/image_diffusion.hpp (FED tau series).  The
reference's documented deviations are kept: a 36-bin gradient-histogram
orientation, and MLDB on a fixed 4x4 grid (3 x 120 comparisons = 360 bits,
packed low bit first with 120 zero bits into 60 bytes).

Everything runs in float32 on the image's device, one octave at a time,
batched over levels and keypoints.  A level's candidates are ranked by a
stable descending sort (ties to the lower flat index, as lax.top_k); the
percentile is a sort with linear interpolation; cell sums are products
with a fixed 0/1 cell matrix, so no float atomics are involved.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from openmvg_torch.ops.sift import _argmax_first, _blur

N_SUBLEVELS = 4
SIGMA0 = 1.6
DET_THRESHOLD = 0.001
PM_K_PERCENTILE = 0.7
MLDB_BYTES = 60


class AkazeConfig(NamedTuple):
    n_octaves: int = 4
    threshold: float = DET_THRESHOLD
    max_per_octave: int = 512
    descriptor: str = "MSURF"  # or "MLDB"
    upright: bool = False      # -u: keep descriptors in the image frame


def _fed_tau_series(T, tau_max=0.25):
    """FED cycle step sizes covering diffusion time T (image_diffusion.hpp)."""
    n = int(np.ceil(np.sqrt(3.0 * T / tau_max + 0.25) - 0.5 - 1e-8)) + 1
    c = 1.0 / (4.0 * n + 2.0)
    taus = [tau_max / (2.0 * np.cos(np.pi * (2 * j + 1) * c) ** 2) for j in range(n)]
    scale = T / sum(taus)
    return [t * scale for t in taus]


def gradient(x):
    """np.gradient over the last two axes of x (..., H, W) -> (d/dy, d/dx):
    central differences inside, first-order one-sided at the edges."""
    def one(a, dim):
        n = a.shape[dim]
        mid = (a.narrow(dim, 2, n - 2) - a.narrow(dim, 0, n - 2)) * 0.5
        lo = a.narrow(dim, 1, 1) - a.narrow(dim, 0, 1)
        hi = a.narrow(dim, n - 1, 1) - a.narrow(dim, n - 2, 1)
        return torch.cat([lo, mid, hi], dim=dim)

    return one(x, -2), one(x, -1)


def _diffuse_step(L, g, tau):
    """One explicit diffusion step with conductivity g (5-point stencil,
    edge-replicated neighbours)."""
    H, W = L.shape
    gp = torch.nn.functional.pad(g[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    Lp = torch.nn.functional.pad(L[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    flow = 0.0
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        gn = 0.5 * (g + gp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
        flow = flow + gn * (Lp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W] - L)
    return L + tau * flow


def _conductivity(L, k):
    """Perona-Malik g2: 1 / (1 + |grad|^2 / k^2)."""
    gy, gx = gradient(_blur(L, 1.0))
    return 1.0 / (1.0 + (gx * gx + gy * gy) / (k * k))


def percentile(x, q):
    """np.percentile(x, q) with linear interpolation, as a sort (no size
    limit, unlike torch.quantile)."""
    v = torch.sort(x.reshape(-1)).values
    pos = q / 100.0 * (v.numel() - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, v.numel() - 1)
    frac = pos - lo
    return v[lo] * (1.0 - frac) + v[hi] * frac


def _contrast_k(L):
    gy, gx = gradient(_blur(L, 1.0))
    mag = torch.sqrt(gx * gx + gy * gy)
    return torch.clamp(percentile(mag, PM_K_PERCENTILE * 100.0), min=1e-6)


def build_nonlinear_scale_space(image, cfg: AkazeConfig):
    """(H, W) float32 -> per-octave stacks [(N_SUBLEVELS, H_o, W_o)] and
    their sigma tables (numpy, image units)."""
    L = _blur(image, SIGMA0)
    k = _contrast_k(L)
    octaves, sigma_tab = [], []
    for o in range(cfg.n_octaves):
        levels, sigmas = [], []
        for s in range(N_SUBLEVELS):
            sigma = SIGMA0 * 2.0 ** (o + s / N_SUBLEVELS)
            sigmas.append(sigma)
            if s == 0:
                levels.append(L)
                continue
            sig_prev = SIGMA0 * 2.0 ** (o + (s - 1) / N_SUBLEVELS)
            delta = 2.0 ** o      # diffusion times in the octave's pixel units
            T = 0.5 * ((sigma / delta) ** 2 - (sig_prev / delta) ** 2)
            g = _conductivity(levels[-1], k)
            Lc = levels[-1]
            for tau in _fed_tau_series(T):
                Lc = _diffuse_step(Lc, g, float(tau))
            levels.append(Lc)
        octaves.append(torch.stack(levels))
        sigma_tab.append(np.asarray(sigmas))
        L = levels[-1][::2, ::2]
    return octaves, sigma_tab


def _hessian_response(stack, sigmas, delta):
    """Scale-normalised det(Hessian) of every level: (D, H, W)."""
    gy, gx = gradient(stack)
    gyy, gyx = gradient(gy)
    _, gxx = gradient(gx)
    sn = torch.as_tensor([(s / delta) ** 2 for s in sigmas], dtype=stack.dtype,
                         device=stack.device)[:, None, None]
    return sn * sn * (gxx * gyy - gyx * gyx)


def top_k_stable(score, k):
    """The k largest of a 1-D tensor, ties to the lower index (lax.top_k):
    (values, indices)."""
    val, idx = torch.sort(score, descending=True, stable=True)
    return val[:k], idx[:k]


def _detect_octave(stack, sigmas, delta, cfg: AkazeConfig):
    det = _hessian_response(stack, sigmas, delta)
    D, H, W = det.shape
    c = det[:, 1:H - 1, 1:W - 1]
    is_max = torch.ones_like(c, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == dx == 0:
                continue
            is_max &= c >= det[:, 1 + dy:H - 1 + dy, 1 + dx:W - 1 + dx]
    cand = is_max & (c > cfg.threshold)
    score = torch.where(cand, c, torch.zeros_like(c)).reshape(-1)
    val, flat = top_k_stable(score, min(cfg.max_per_octave, score.numel()))
    valid = val > 0
    s0 = flat // ((H - 2) * (W - 2))
    rem = flat % ((H - 2) * (W - 2))
    y0 = rem // (W - 2) + 1
    x0 = rem % (W - 2) + 1

    # 2-D sub-pixel refinement on the response map
    def g(dy, dx):
        return det[s0, y0 + dy, x0 + dx]

    dx_ = 0.5 * (g(0, 1) - g(0, -1))
    dy_ = 0.5 * (g(1, 0) - g(-1, 0))
    dxx = g(0, 1) + g(0, -1) - 2 * g(0, 0)
    dyy = g(1, 0) + g(-1, 0) - 2 * g(0, 0)
    dxy = 0.25 * (g(1, 1) - g(1, -1) - g(-1, 1) + g(-1, -1))
    det2 = dxx * dyy - dxy * dxy
    ok = det2.abs() > 1e-12
    den = torch.where(det2 == 0, torch.full_like(det2, 1e-12), det2)
    zero = torch.zeros_like(det2)
    ox = torch.clamp(torch.where(ok, -(dyy * dx_ - dxy * dy_) / den, zero), -1.0, 1.0)
    oy = torch.clamp(torch.where(ok, -(dxx * dy_ - dxy * dx_) / den, zero), -1.0, 1.0)
    return dict(level=s0, y=y0 + oy, x=x0 + ox, value=val, valid=valid)


def _sample_levels(chans, level, ys, xs):
    """Bilinear samples of per-level maps: chans (C, L, H, W), level (K,),
    ys/xs (K, S) -> (C, K, S), clamped as ops/sift.py::_bilinear."""
    C, L, H, W = chans.shape
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, H - 2)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, W - 2)
    fy = torch.clamp(ys - y0, 0.0, 1.0)
    fx = torch.clamp(xs - x0, 0.0, 1.0)
    base = (level[:, None] * H + y0) * W + x0
    flat = chans.reshape(C, L * H * W)

    def at(off):
        return flat[:, base + off]

    return (at(0) * (1 - fy) * (1 - fx) + at(1) * (1 - fy) * fx
            + at(W) * fy * (1 - fx) + at(W + 1) * fy * fx)


def _grid(lin, device):
    """jnp.meshgrid(lin, lin) flattened: (U, V), U along the columns."""
    lin = torch.as_tensor(lin, dtype=torch.float32, device=device)
    V, U = torch.meshgrid(lin, lin, indexing="ij")
    return U.reshape(-1), V.reshape(-1)


def _cell_matrix(lin, device):
    """(S, 16) 0/1 matrix of the 4x4 cell of each grid sample, with the
    reference's cell rule clip(int((u + 1) / 2 * 4), 0, 3)."""
    G = len(lin)
    b = np.clip(((np.asarray(lin, np.float32) + 1.0) * 0.5 * 4).astype(np.int32), 0, 3)
    cell = (b[:, None] * 4 + b[None, :]).reshape(-1)      # row v, column u
    m = np.zeros((G * G, 16), np.float32)
    m[np.arange(G * G), cell] = 1.0
    return torch.as_tensor(m, device=device)


def _orientation(grads, level, y, x, sigma_pix, grid=13):
    """Dominant direction of a 36-bin gradient histogram per keypoint:
    grads (2, L, H, W) = (gx, gy)."""
    U, V = _grid(np.linspace(-1.0, 1.0, grid), grads.device)
    rad = 6.0
    sy = y[:, None] + V * rad * sigma_pix[:, None]
    sx = x[:, None] + U * rad * sigma_pix[:, None]
    gxs, gys = _sample_levels(grads, level, sy, sx)
    w = torch.exp(-0.5 * (U ** 2 + V ** 2) * 4.0)
    mag = torch.hypot(gxs, gys) * w
    ang = torch.remainder(torch.atan2(gys, gxs), 2 * math.pi)
    b = torch.remainder(torch.floor(ang / (2 * math.pi) * 36).to(torch.int64), 36)
    onehot = torch.nn.functional.one_hot(b, 36).to(mag.dtype)
    hist = torch.einsum("ks,ksb->kb", mag, onehot)
    for _ in range(3):
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    pk = _argmax_first(hist)
    return (pk.to(torch.float32) + 0.5) / 36.0 * 2 * math.pi


def _rotated_samples(chans, level, y, x, sigma_pix, theta, U, V, R):
    """Samples of chans on a grid (U, V) in [-1, 1]^2 of half-width R
    sigmas, rotated by theta: (C, K, S)."""
    ct, st = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    du = U * R * sigma_pix[:, None]
    dv = V * R * sigma_pix[:, None]
    sx = x[:, None] + ct * du - st * dv
    sy = y[:, None] + st * du + ct * dv
    return _sample_levels(chans, level, sy, sx), ct, st


def _msurf_descriptor(grads, level, y, x, sigma_pix, theta, grid=24):
    """4x4 subregions x (sum dx, sum dy, sum |dx|, sum |dy|) = 64-d."""
    lin = (np.arange(grid) + 0.5) / grid * 2.0 - 1.0
    U, V = _grid(lin, grads.device)
    R = 12.0   # pattern half-width in sigmas (MSURF 24x24 samples)
    (gxs, gys), ct, st = _rotated_samples(grads, level, y, x, sigma_pix, theta, U, V, R)
    rx = ct * gxs + st * gys          # gradients in the keypoint frame
    ry = -st * gxs + ct * gys
    w = torch.exp(-0.5 * (U ** 2 + V ** 2) * (R / 6.0) ** 2)
    rx = rx * w
    ry = ry * w
    f = torch.stack([rx, ry, rx.abs(), ry.abs()], dim=-1)            # (K, S, 4)
    d = torch.einsum("ksc,sg->kgc", f, _cell_matrix(lin, grads.device)).reshape(-1, 64)
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)


def _packbits(bits):
    """(..., 8n) 0/1 -> (..., n) uint8, low bit first."""
    w = torch.tensor([1 << i for i in range(8)], dtype=torch.int32, device=bits.device)
    b = bits.reshape(bits.shape[:-1] + (-1, 8)).to(torch.int32)
    return (b * w).sum(-1).to(torch.uint8)


def _mldb_descriptor(stack, grads, level, y, x, sigma_pix, theta, grid=10):
    """Binary comparisons of (intensity, dx, dy) cell means over a 4x4 grid
    of cells: all 120 pairs x 3 channels = 360 bits, channel-major, padded
    with zeros to 480 bits = 60 bytes."""
    lin = (np.arange(grid) + 0.5) / grid * 2.0 - 1.0
    U, V = _grid(lin, grads.device)
    R = 10.0
    chans = torch.cat([stack[None], grads])                          # (3, L, H, W)
    (li, gxs, gys), ct, st = _rotated_samples(chans, level, y, x, sigma_pix, theta, U, V, R)
    rx = ct * gxs + st * gys
    ry = -st * gxs + ct * gys
    M = _cell_matrix(lin, grads.device)
    cnt = torch.clamp(M.sum(0), min=1.0)
    f = torch.stack([li, rx, ry], dim=-1)                            # (K, S, 3)
    means = torch.einsum("ksc,sg->kgc", f, M) / cnt[None, :, None]   # (K, 16, 3)
    iu, ju = torch.triu_indices(16, 16, 1, device=grads.device)
    bits = (means[:, iu] > means[:, ju]).transpose(1, 2).reshape(-1, 360)
    bits = torch.cat([bits, bits.new_zeros((bits.shape[0], 8 * MLDB_BYTES - 360))], dim=1)
    return _packbits(bits)


def extract(image, cfg: AkazeConfig = AkazeConfig()):
    """(H, W) image tensor -> dict of per-keypoint tensors (xy, scale,
    orientation, desc, mask, response), max_per_octave slots per octave."""
    octaves, sigma_tab = build_nonlinear_scale_space(image.to(torch.float32), cfg)
    outs = []
    for o, stack in enumerate(octaves):
        delta = 2.0 ** o
        kp = _detect_octave(stack, sigma_tab[o], delta, cfg)
        gy, gx = gradient(stack)
        grads = torch.stack([gx, gy])
        sigma_pix = torch.as_tensor(sigma_tab[o], dtype=torch.float32,
                                    device=stack.device)[kp["level"]] / delta
        theta = (torch.zeros_like(kp["x"]) if cfg.upright else
                 _orientation(grads, kp["level"], kp["y"], kp["x"], sigma_pix))
        if cfg.descriptor == "MSURF":
            desc = _msurf_descriptor(grads, kp["level"], kp["y"], kp["x"], sigma_pix, theta)
        else:
            desc = _mldb_descriptor(stack, grads, kp["level"], kp["y"], kp["x"], sigma_pix,
                                    theta)
        outs.append(dict(xy=torch.stack([kp["x"] * delta, kp["y"] * delta], -1),
                         scale=sigma_pix * delta, orientation=theta, desc=desc,
                         mask=kp["valid"], response=kp["value"]))
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def extract_to_numpy(image, method="AKAZE_FLOAT", max_features=8192, cfg: AkazeConfig = None,
                     upright=False, device="cuda"):
    """(H, W) float [0, 1] -> (feats (N, 4) [x y scale ori] float32, descs:
    (N, 64) float32 for MSURF, (N, 60) uint8 for MLDB), strongest first."""
    if cfg is None:
        cfg = AkazeConfig(descriptor="MLDB" if "MLDB" in method else "MSURF", upright=upright)
    f = extract(torch.as_tensor(np.asarray(image, np.float32), device=device), cfg)
    f = {k: v.cpu().numpy() for k, v in f.items()}
    idx = np.nonzero(f["mask"])[0]
    order = idx[np.argsort(-f["response"][idx], kind="stable")][:max_features]
    feats = np.concatenate([f["xy"][order], f["scale"][order][:, None],
                            f["orientation"][order][:, None]], axis=1)
    return feats, f["desc"][order]
