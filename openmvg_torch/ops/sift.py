"""SIFT feature extraction in PyTorch (counterpart: openmvg_tpu/ops/sift.py).

Reference parity (features/sift/, the IPOL "Anatomy of SIFT" port): the
hierarchical Gaussian scale space (sigma_min 1.6, sigma_in 0.5, 3 slices
per octave + 3 supplementary levels, octave chaining by 2x subsampling of
level 3), 26-neighbour DoG extrema with a 0.8x peak prefilter, quadratic
refinement, contrast threshold peak/n_slices, edge rejection (r+1)^2/r
with r = 10, 36-bin orientation histograms (lambda_ori 1.5, 6x box
smoothing, peaks >= 0.8 max), 4x4x8 descriptors (lambda_desc 6, clip 0.2,
quantised x512 to uint8).

The outputs line up slot for slot with the reference: a fixed per-octave
top-K of candidates (ties to the lower flat index, as lax.top_k), two
orientation slots per keypoint, and the same fixed sample grids for the
orientation and descriptor windows.  Every function takes a written-out
batch dimension B in place of vmap.  The separable blurs are F.conv2d in
full f32 (openmvg_torch/__init__.py turns cuDNN's TF32 off: the DoG is a
difference of two blurs and reduced precision multiplies detections).
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

SIGMA_MIN = 1.6
SIGMA_IN = 0.5
N_SLICES = 3
N_LEVELS = N_SLICES + 3
LAMBDA_ORI = 1.5
LAMBDA_DESC = 6.0
N_ORI_BINS = 36
N_SPLIT = 4
N_ANGLE = 8
CLIP = 0.2
_TWO_PI = 2 * np.pi


class SiftConfig(NamedTuple):
    peak_threshold: float = 0.04     # NORMAL preset
    edge_threshold: float = 10.0
    max_per_octave: int = 1024
    n_octaves: int = 4
    ori_grid: int = 16
    desc_grid: int = 16
    root_sift: bool = False
    first_octave: int = 0            # -1 = ULTRA (input upsampled 2x)


class SiftFeatures(NamedTuple):
    xy: torch.Tensor           # (B, K, 2) image coords (x, y)
    scale: torch.Tensor        # (B, K)
    orientation: torch.Tensor  # (B, K)
    desc: torch.Tensor         # (B, K, 128) uint8
    mask: torch.Tensor         # (B, K) bool
    response: torch.Tensor     # (B, K) |DoG| response


def _gauss_kernel1d(sigma, radius):
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(img, sigma):
    """Separable Gaussian blur with edge padding; img (..., H, W), the
    float32 kernel taken in img's dtype."""
    radius = max(1, int(np.ceil(4.0 * sigma)))
    k = torch.as_tensor(_gauss_kernel1d(sigma, radius), device=img.device).to(img.dtype)
    x = F.pad(img.reshape((-1, 1) + img.shape[-2:]), (radius, radius, radius, radius),
              mode="replicate")
    x = F.conv2d(x, k.view(1, 1, 1, -1))
    x = F.conv2d(x, k.view(1, 1, -1, 1))
    return x.reshape(img.shape)


def _blur_levels(img, sigmas):
    """Every level of an octave straight from level 0: img (B, H, W),
    sigmas L floats (sigmas[0] = 0, the identity) -> (B, L, H, W).  The
    horizontal pass makes L channels from 1, the vertical pass is depthwise;
    the Gaussian semigroup makes this the incremental blur chain."""
    L = len(sigmas)
    R = max(1, int(np.ceil(4.0 * max(sigmas[1:]))))
    ks = np.zeros((L, 2 * R + 1), np.float32)
    ks[0, R] = 1.0
    for s in range(1, L):
        r = max(1, int(np.ceil(4.0 * sigmas[s])))
        ks[s, R - r:R + r + 1] = _gauss_kernel1d(sigmas[s], r)
    k = torch.as_tensor(ks, device=img.device)
    x = F.pad(img[:, None], (R, R, R, R), mode="replicate")
    x = F.conv2d(x, k.view(L, 1, 1, 2 * R + 1))
    return F.conv2d(x, k.view(L, 1, 2 * R + 1, 1), groups=L)


def _upsample2(img):
    """2x linear upsample of (B, H, W), clamped at the far edge
    (image_resampling.hpp:70 ImageUpsample)."""
    def up(a, dim):
        nxt = torch.cat([a.narrow(dim, 1, a.shape[dim] - 1),
                         a.narrow(dim, a.shape[dim] - 1, 1)], dim=dim)
        st = torch.stack([a, 0.5 * (a + nxt)], dim=dim + 1)
        shape = list(a.shape)
        shape[dim] *= 2
        return st.reshape(shape)

    return up(up(img, 1), 2)


def build_scale_space(image, cfg: SiftConfig):
    """(B, H, W) float32 in [0, 1] -> list of per-octave (B, N_LEVELS,
    H_o, W_o) stacks, and per-octave level sigmas in input-image units."""
    delta0 = 2.0 ** cfg.first_octave
    if cfg.first_octave == -1:
        image = _upsample2(image)
    elif cfg.first_octave != 0:
        raise ValueError("first_octave must be 0 or -1 "
                         "(hierarchical_gaussian_scale_space.hpp SetImage)")
    img = _blur(image, float(np.sqrt(SIGMA_MIN**2 - (SIGMA_IN / delta0)**2)))
    cum = [0.0] + [float(SIGMA_MIN * np.sqrt(2.0 ** (2.0 * s / N_SLICES) - 1.0))
                   for s in range(1, N_LEVELS)]
    octaves, sigmas = [], []
    for o in range(cfg.n_octaves):
        stack = _blur_levels(img, cum)
        octaves.append(stack)
        sigmas.append(SIGMA_MIN * delta0 * 2.0 ** o *
                      2.0 ** (np.arange(N_LEVELS) / N_SLICES))
        img = stack[:, N_SLICES, ::2, ::2]
    return octaves, sigmas


def _top_k_stable(score, k):
    """(B, n) -> values, indices of the k largest per row, equal values in
    ascending index order (the lax.top_k order)."""
    val, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return val[:, :k], idx[:, :k]


def _solve3(Hm, g):
    """Closed-form 3x3 solve by the adjugate; Hm (..., 3, 3), g (..., 3)."""
    a, b_, c = Hm[..., 0, 0], Hm[..., 0, 1], Hm[..., 0, 2]
    d, e, f = Hm[..., 1, 0], Hm[..., 1, 1], Hm[..., 1, 2]
    g_, h, i = Hm[..., 2, 0], Hm[..., 2, 1], Hm[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g_)
    C = d * h - e * g_
    det = a * A + b_ * B + c * C
    det = torch.where(det.abs() < 1e-20,
                      torch.where(det < 0, -1e-20, 1e-20).to(det.dtype), det)
    D_ = -(b_ * i - c * h)
    E = a * i - c * g_
    F_ = -(a * h - b_ * g_)
    G = b_ * f - c * e
    Hh = -(a * f - c * d)
    I_ = a * e - b_ * d
    x0 = (A * g[..., 0] + D_ * g[..., 1] + G * g[..., 2]) / det
    x1 = (B * g[..., 0] + E * g[..., 1] + Hh * g[..., 2]) / det
    x2 = (C * g[..., 0] + F_ * g[..., 1] + I_ * g[..., 2]) / det
    return torch.stack([x0, x1, x2], dim=-1)


_OFFS = torch.tensor([(ds, dy, dx) for ds in (-1, 0, 1) for dy in (-1, 0, 1)
                      for dx in (-1, 0, 1)])


def _neighbourhood(dog, s, y, x):
    """(B, D, H, W) DoG, (B, K) centres -> (B, K, 3, 3, 3) windows."""
    B, D, H, W = dog.shape
    offs = _OFFS.to(dog.device)
    ss = s[..., None] + offs[:, 0]
    yy = y[..., None] + offs[:, 1]
    xx = x[..., None] + offs[:, 2]
    flat = (ss * H + yy) * W + xx
    w = torch.gather(dog.reshape(B, -1), 1, flat.reshape(B, -1))
    return w.reshape(s.shape + (3, 3, 3))


def _deriv(w):
    v = w[..., 1, 1, 1]
    grad = 0.5 * torch.stack([w[..., 2, 1, 1] - w[..., 0, 1, 1],
                              w[..., 1, 2, 1] - w[..., 1, 0, 1],
                              w[..., 1, 1, 2] - w[..., 1, 1, 0]], dim=-1)
    hss = w[..., 2, 1, 1] + w[..., 0, 1, 1] - 2 * v
    hyy = w[..., 1, 2, 1] + w[..., 1, 0, 1] - 2 * v
    hxx = w[..., 1, 1, 2] + w[..., 1, 1, 0] - 2 * v
    hsy = 0.25 * (w[..., 2, 2, 1] - w[..., 2, 0, 1] - w[..., 0, 2, 1] + w[..., 0, 0, 1])
    hsx = 0.25 * (w[..., 2, 1, 2] - w[..., 2, 1, 0] - w[..., 0, 1, 2] + w[..., 0, 1, 0])
    hyx = 0.25 * (w[..., 1, 2, 2] - w[..., 1, 2, 0] - w[..., 1, 0, 2] + w[..., 1, 0, 0])
    Hm = torch.stack([torch.stack([hss, hsy, hsx], -1),
                      torch.stack([hsy, hyy, hyx], -1),
                      torch.stack([hsx, hyx, hxx], -1)], -2)
    return v, grad, Hm, (hxx, hyy, hyx)


def _detect_octave(stack, cfg: SiftConfig):
    """One octave's DoG extrema with quadratic refinement.

    stack (B, N_LEVELS, H, W).  Returns a dict of (B, K) tensors, K =
    min(max_per_octave, interior voxels): level, s, y, x (octave px,
    refined), sigma_rel (octave px), value, valid.
    """
    dog = stack[:, 1:] - stack[:, :-1]
    B, D, H, W = dog.shape
    thresh = cfg.peak_threshold / N_SLICES

    c = dog[:, 1:D - 1, 1:H - 1, 1:W - 1]
    is_max = torch.ones_like(c, dtype=torch.bool)
    is_min = torch.ones_like(c, dtype=torch.bool)
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == dy == dx == 0:
                    continue
                n = dog[:, 1 + ds:D - 1 + ds, 1 + dy:H - 1 + dy,
                        1 + dx:W - 1 + dx]
                is_max &= c > n
                is_min &= c < n
    cand = (is_max | is_min) & (c.abs() > 0.8 * thresh)
    score = torch.where(cand, c.abs(), torch.zeros_like(c)).reshape(B, -1)
    K = min(cfg.max_per_octave, score.shape[1])
    val, flat = _top_k_stable(score, K)
    valid = val > 0
    Wc = W - 2
    s = flat // ((H - 2) * Wc) + 1
    rem = flat % ((H - 2) * Wc)
    y = rem // Wc + 1
    x = rem % Wc + 1

    for _ in range(3):  # anchor moves, clamped to the interior
        _, grad, Hm, _ = _deriv(_neighbourhood(dog, s, y, x))
        off = -_solve3(Hm, grad)
        shift = torch.round(off).to(torch.int64)
        move = off.abs() > 0.6
        s = torch.clamp(s + torch.where(move[..., 0], shift[..., 0], 0), 1, D - 2)
        y = torch.clamp(y + torch.where(move[..., 1], shift[..., 1], 0), 1, H - 2)
        x = torch.clamp(x + torch.where(move[..., 2], shift[..., 2], 0), 1, W - 2)
    v, grad, Hm, (hxx, hyy, hyx) = _deriv(_neighbourhood(dog, s, y, x))
    off = torch.clamp(-_solve3(Hm, grad), -1.5, 1.5)
    val_ref = v + 0.5 * torch.sum(grad * off, dim=-1)
    tr = hxx + hyy
    det = hxx * hyy - hyx * hyx
    r = cfg.edge_threshold
    edge_ok = (det > 0) & (tr * tr / torch.where(det == 0, 1e-12, det).to(det.dtype)
                           < (r + 1) ** 2 / r)
    contrast_ok = val_ref.abs() > thresh
    valid = valid & edge_ok & contrast_ok

    sr = s + off[..., 0]
    yr = y + off[..., 1]
    xr = x + off[..., 2]
    sigma_rel = SIGMA_MIN * 2.0 ** (sr / N_SLICES)
    border_ok = (xr > 1.0) & (xr < W - 2.0) & (yr > 1.0) & (yr < H - 2.0)
    return dict(level=torch.clamp(torch.round(sr).to(torch.int64), 0, N_LEVELS - 1),
                s=sr, y=yr, x=xr, sigma_rel=sigma_rel, value=val_ref,
                valid=valid & border_ok)


def _bilinear(img, y, x):
    """img (H, W), y/x float tensors -> bilinear samples (clamped)."""
    H, W = img.shape
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    return (img[y0, x0] * (1 - fy) * (1 - fx) + img[y0, x0 + 1] * (1 - fy) * fx
            + img[y0 + 1, x0] * fy * (1 - fx) + img[y0 + 1, x0 + 1] * fy * fx)


def _sample_grads(g, level, ys, xs):
    """Bilinear samples of both gradient channels of one level per keypoint.

    g (B, 2, L, H, W) with g[:, 0] = gx, g[:, 1] = gy; level (B, K) int;
    ys, xs (B, K, S).  Returns (gx_s, gy_s), each (B, K, S).  Clamping is
    that of _bilinear."""
    B, C, L, H, W = g.shape
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, H - 2)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, W - 2)
    fy = torch.clamp(ys - y0, 0.0, 1.0)
    fx = torch.clamp(xs - x0, 0.0, 1.0)
    base = (level[..., None] * H + y0) * W + x0
    idx = torch.stack([base, base + 1, base + W, base + W + 1], dim=2)
    flat = g.reshape(B, C, L * H * W)
    p = torch.gather(flat, 2, idx.reshape(B, 1, -1).expand(B, C, -1))
    p = p.reshape((B, C) + idx.shape[1:])               # (B, C, K, 4, S)
    w = torch.stack([(1 - fy) * (1 - fx), (1 - fy) * fx,
                     fy * (1 - fx), fy * fx], dim=2)    # (B, K, 4, S)
    v = torch.sum(p * w[:, None], dim=3)                # (B, C, K, S)
    return v[:, 0], v[:, 1]


def _grid(G, device):
    lin = torch.linspace(-1.0, 1.0, G, device=device)
    V, U = torch.meshgrid(lin, lin, indexing="ij")  # jnp.meshgrid(lin, lin)
    return U.reshape(-1), V.reshape(-1)


def _argmax_first(x):
    """Index of the first maximum along the last axis."""
    m = x.max(dim=-1, keepdim=True).values
    n = x.shape[-1]
    ar = torch.arange(n, device=x.device).expand_as(x)
    return torch.where(x == m, ar, n).min(dim=-1).values


def _orientations(g, kp, cfg: SiftConfig):
    """Dominant orientations (up to 2) per keypoint.

    g (B, 2, N_LEVELS, H, W); kp from _detect_octave.  Returns theta
    (B, K, 2), ok (B, K, 2)."""
    Uf, Vf = _grid(cfg.ori_grid, g.device)
    rad = 3.0 * LAMBDA_ORI
    sig = kp["sigma_rel"][..., None]
    sy = kp["y"][..., None] + Vf * rad * sig
    sx = kp["x"][..., None] + Uf * rad * sig
    gxs, gys = _sample_grads(g, kp["level"], sy, sx)
    mag = torch.hypot(gxs, gys)
    w = torch.exp(-0.5 * ((Uf ** 2 + Vf ** 2) * rad**2) / LAMBDA_ORI**2)
    ang = torch.atan2(gys, gxs) % _TWO_PI
    b0 = torch.floor(ang / _TWO_PI * N_ORI_BINS).to(torch.int64) % N_ORI_BINS
    # a product with the one-hot bins, not scatter_add_: on CUDA that adds
    # with atomics in an order that changes from run to run, and so would
    # the keypoints whose orientation peaks sit near a tie
    onehot = F.one_hot(b0, N_ORI_BINS).to(mag.dtype)          # (B, K, S, 36)
    hist = ((w * mag)[..., None, :] @ onehot)[..., 0, :]
    for _ in range(6):  # circular box smoothing
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    hmax = hist.max(dim=-1, keepdim=True).values
    prev = torch.roll(hist, 1, -1)
    nxt = torch.roll(hist, -1, -1)
    is_peak = (hist > prev) & (hist > nxt) & (hist >= 0.8 * hmax)
    peak_val = torch.where(is_peak, hist, torch.full_like(hist, -1.0))
    # top-2 with ties to the lower bin (the lax.top_k order)
    i1 = _argmax_first(peak_val)
    masked = peak_val.scatter(-1, i1[..., None], float("-inf"))
    i2 = _argmax_first(masked)
    top_idx = torch.stack([i1, i2], dim=-1)
    top_val = torch.gather(peak_val, -1, top_idx)
    p = torch.gather(prev, -1, top_idx)
    c = torch.gather(hist, -1, top_idx)
    n = torch.gather(nxt, -1, top_idx)
    denom = p - 2 * c + n
    safe = denom.abs() > 1e-12
    off = torch.where(safe, 0.5 * (p - n) / torch.where(safe, denom, 1.0),
                      torch.zeros_like(denom))
    theta = ((top_idx + off + 0.5) / N_ORI_BINS) * _TWO_PI
    return theta, top_val > 0


def _descriptors(g, kp, theta, cfg: SiftConfig):
    """4x4x8 descriptors for each (keypoint, orientation); theta (B, K)."""
    Uf, Vf = _grid(cfg.desc_grid, g.device)
    R = (1.0 + 1.0 / N_SPLIT) * LAMBDA_DESC
    sig = kp["sigma_rel"][..., None]
    th = theta[..., None]
    ct, st = torch.cos(th), torch.sin(th)
    du = Uf * R * sig
    dv = Vf * R * sig
    sx = kp["x"][..., None] + ct * du - st * dv
    sy = kp["y"][..., None] + st * du + ct * dv
    gxs, gys = _sample_grads(g, kp["level"], sy, sx)
    mag = torch.hypot(gxs, gys)
    ang = (torch.atan2(gys, gxs) - th) % _TWO_PI
    w = torch.exp(-0.5 * (Uf**2 + Vf**2) * R**2 / LAMBDA_DESC**2)
    contrib = w * mag                                          # (B, K, S)
    # trilinear binning as hat weights: the spatial weights depend only on
    # the fixed grid, the angle weights per sample
    ub = (Uf * R + LAMBDA_DESC) / (2 * LAMBDA_DESC) * N_SPLIT - 0.5
    vb = (Vf * R + LAMBDA_DESC) / (2 * LAMBDA_DESC) * N_SPLIT - 0.5
    ku = torch.arange(N_SPLIT, dtype=ub.dtype, device=ub.device)
    wu = torch.clamp(1.0 - (ub[:, None] - ku).abs(), min=0.0)  # (S, 4)
    wv = torch.clamp(1.0 - (vb[:, None] - ku).abs(), min=0.0)
    Bw = (wv[:, :, None] * wu[:, None, :]).reshape(-1, N_SPLIT * N_SPLIT)
    ab = ang / _TWO_PI * N_ANGLE
    ka = torch.arange(N_ANGLE, dtype=ab.dtype, device=ab.device)
    da = (ab[..., None] - ka).abs()
    wa = torch.clamp(1.0 - torch.minimum(da, N_ANGLE - da), min=0.0)  # (B,K,S,8)
    desc = torch.einsum("su,bksa->bkua", Bw, wa * contrib[..., None])
    desc = desc.reshape(desc.shape[:2] + (-1,))
    nrm = torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)
    desc = torch.clamp(desc / nrm, max=CLIP)
    nrm2 = torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)
    desc = desc / nrm2
    if cfg.root_sift:
        desc = torch.sqrt(desc / torch.clamp(desc.sum(-1, keepdim=True), min=1e-12))
    return torch.clamp(desc * 512.0, 0, 255).to(torch.uint8)


def extract_batch(images, cfg: SiftConfig = SiftConfig(), upright=False):
    """SIFT on a batch of same-shape gray images (B, H, W) float32 in [0, 1].

    Returns SiftFeatures with K = sum over octaves of n_slots * K_o slots,
    ordered octave by octave, slot by slot, as the reference orders them."""
    octaves, _ = build_scale_space(images, cfg)
    outs = []
    for o, stack in enumerate(octaves):
        delta = 2.0 ** (o + cfg.first_octave)
        kp = _detect_octave(stack, cfg)
        gy, gx = torch.gradient(stack, dim=(-2, -1))
        g = torch.stack([gx, gy], dim=1)  # (B, 2, L, H, W)
        if upright:
            theta = torch.zeros(kp["x"].shape + (1,), dtype=images.dtype,
                                device=images.device)
            ok_theta = torch.ones_like(theta, dtype=torch.bool)
        else:
            theta, ok_theta = _orientations(g, kp, cfg)
        for slot in range(theta.shape[-1]):
            th = theta[..., slot]
            outs.append(SiftFeatures(
                xy=torch.stack([kp["x"] * delta, kp["y"] * delta], -1),
                scale=kp["sigma_rel"] * delta,
                orientation=th,
                desc=_descriptors(g, kp, th, cfg),
                mask=kp["valid"] & ok_theta[..., slot],
                response=kp["value"].abs()))
    return SiftFeatures(*[torch.cat([getattr(f, n) for f in outs], dim=1)
                          for n in SiftFeatures._fields])


def extract(image, cfg: SiftConfig = SiftConfig(), upright=False):
    """SIFT on one gray image (H, W); SiftFeatures without the batch dim."""
    f = extract_batch(image[None], cfg, upright=upright)
    return SiftFeatures(*[x[0] for x in f])


def compact(f: SiftFeatures, max_features=None):
    """One image's slots -> (feats (N, 4) [x y scale ori] float32, descs
    (N, 128) uint8) numpy, valid rows by descending response (stable)."""
    mask = f.mask.cpu().numpy()
    resp = f.response.cpu().numpy()
    idx = np.nonzero(mask)[0]
    order = idx[np.argsort(-resp[idx], kind="stable")]
    if max_features is not None:
        order = order[:max_features]
    feats = np.concatenate([f.xy.cpu().numpy()[order],
                            f.scale.cpu().numpy()[order][:, None],
                            f.orientation.cpu().numpy()[order][:, None]], axis=1)
    return feats, f.desc.cpu().numpy()[order]


def extract_to_numpy(image, cfg: SiftConfig = SiftConfig(), max_features=None,
                     upright=False, device="cuda"):
    """Host convenience: extract on `device` (the card unless the caller
    asks for the CPU), compact to numpy."""
    img = torch.as_tensor(np.asarray(image, np.float32), device=device)
    return compact(extract(img, cfg, upright=upright), max_features)
