"""K-VLD photometric and geometric match verification (counterpart:
openmvg_tpu/ops/kvld.py; Liu & Moulon, matching/kvld/{kvld.h,kvld.cpp,
algorithm.h}).

A virtual line descriptor (VLD) describes the segment joining two features
of one image: 10 discs along it, each with a 24-bin gradient-orientation
histogram (principal angle and weight) and an 8-bin mini descriptor,
sampled from a sqrt(2)-step box-downsampled gradient pyramid.  Two matches
are consistent when their VLDs differ by less than 0.35 and the segment is
geometrically consistent (< 0.5); a match needs K = 3 consistent
neighbours, with duplicate-endpoint pruning and geometric re-scoring until
a fixed point.

The port keeps the reference's recast: the whole E-matrix of VLD
differences over the gated candidate pairs is computed up front, in
chunks, instead of openMVG's lazily filled, order-dependent cache with its
max_connection early break; the fixed-point pruning then runs on the host.
Candidate sets differ from openMVG's only through that break.  The
integral-image pyramid is built on the host (numpy, gradients stored in
float32, as in the reference); the batched VLD extraction runs on `device`
in float64, because JUGE (0.35) and DISTANCE_THRES (0.5) are hard cuts on
float sums that float32 could flip.  Its histograms are sums over one bin
at a time (no scatter, no float atomics), so they repeat bit for bit.

Expected image range [0, 255] (contrast gate maxContrast = 300, kvld.h:25).
"""

import math

import numpy as np
import torch

# kvld.h:21-30
JUGE = 0.35
MAX_CONNECTION = 20
DISTANCE_THRES = 0.5
MIN_DIST = 10.0
MAX_CONTRAST = 300.0
DIMENSION = 10
SUBDIR = 8
BINNUM = 24
WIN = 13  # fixed disc sampling window (effective radius <= 5px at level)


# ---------------------------------------------------------------------------
# gradient pyramid (ImageScale, kvld.cpp:20-96)
# ---------------------------------------------------------------------------

def build_image_scale(image, radius_size=5.0):
    """sqrt(2)-step box-averaged pyramid of gradient angle/magnitude.

    Returns dict with stacked padded numpy arrays: angles/mags (L, H, W)
    float32, whs (L, 2) int, ratios (L,).  angle is in [0, 2pi), -1 where the
    gradient is zero (anglefrom convention)."""
    I = np.asarray(image, np.float64)
    H, W = I.shape
    step = math.sqrt(2.0)
    n_levels = int(math.log(max(H, W) / radius_size) / math.log(2.0)) + 1

    # integral image for box resampling (IntegralImages, algorithm.cpp)
    ii = np.zeros((H + 1, W + 1))
    ii[1:, 1:] = np.cumsum(np.cumsum(I, 0), 1)

    def box(cx, cy, r):
        """mean of I over the r x r box centered at (cx, cy) (clipped)."""
        x0 = np.clip(np.floor(cx - r / 2).astype(int), 0, W)
        x1 = np.clip(np.floor(cx + r / 2).astype(int), 0, W)
        y0 = np.clip(np.floor(cy - r / 2).astype(int), 0, H)
        y1 = np.clip(np.floor(cy + r / 2).astype(int), 0, H)
        area = np.maximum((x1 - x0) * (y1 - y0), 1)
        return (ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]) / area

    angles = np.full((n_levels, H, W), -1.0, np.float32)
    mags = np.zeros((n_levels, H, W), np.float32)
    whs = np.zeros((n_levels, 2), np.int32)
    ratios = np.zeros(n_levels)
    for k in range(n_levels):
        ratio = step ** k
        w, h = int(W / ratio), int(H / ratio)
        if k == 0:
            lvl = I
        else:
            xs = (np.arange(w) + 0.5) * ratio
            ys = (np.arange(h) + 0.5) * ratio
            lvl = box(xs[None, :], ys[:, None], ratio)
        gx = np.zeros((h, w))
        gy = np.zeros((h, w))
        gx[1:-1, 1:-1] = lvl[1:-1, 2:] - lvl[1:-1, :-2]
        gy[1:-1, 1:-1] = lvl[2:, 1:-1] - lvl[:-2, 1:-1]
        m = np.hypot(gx, gy)
        ang = np.arctan2(gy, gx)
        ang = np.where(ang < 0, ang + 2 * np.pi, ang)
        ang = np.where(m > 0, ang, -1.0)
        angles[k, :h, :w] = ang
        mags[k, :h, :w] = m
        whs[k] = (w, h)
        ratios[k] = ratio
    return dict(angles=angles, mags=mags, whs=whs, ratios=ratios,
                radius_size=radius_size)


# ---------------------------------------------------------------------------
# batched VLD (kvld.cpp:98-193)
# ---------------------------------------------------------------------------

def pyramid_on(pyr, device):
    """build_image_scale's arrays as float64 (angles, mags, ratios) and
    int64 (whs) tensors on `device`."""
    def f64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    return dict(angles=f64(pyr["angles"]), mags=f64(pyr["mags"]), ratios=f64(pyr["ratios"]),
                whs=torch.as_tensor(np.asarray(pyr["whs"], np.int64), device=device),
                radius_size=float(pyr["radius_size"]))


def _mod(x, y):
    """Floor modulo from an exact fmod: the result takes the sign of y."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _vld_batch(pyr, p1, p2):
    """VLDs of the n segments p1 -> p2 (n, 2) full-resolution pixels, float64,
    on the pyramid's device.  Returns (descriptor (n, 80), principal (n, 10)
    int, weight (n, 10), contrast (n,))."""
    angles, mags, whs, ratios = pyr["angles"], pyr["mags"], pyr["whs"], pyr["ratios"]
    n_levels, H, W = angles.shape
    two_pi = 2 * math.pi
    d = p2 - p1
    distance = torch.sqrt((d * d).sum(-1))
    radius = torch.clamp(distance / (DIMENSION + 1), min=2.0)
    # getIndex (kvld.cpp:81-96): the smallest k with radius <= radius_size * step^k
    lvl = torch.ceil(torch.log(torch.clamp(radius / pyr["radius_size"], min=1.0))
                     / math.log(math.sqrt(2.0)) - 1e-9).to(torch.int64)
    lvl = torch.clamp(lvl, 0, n_levels - 1)
    ratio = ratios[lvl]
    w, h = whs[lvl, 0], whs[lvl, 1]
    r = radius / ratio
    sigma2 = r * r

    main_angle = torch.atan2(d[:, 1], d[:, 0])
    main_angle = torch.where(main_angle < 0, main_angle + two_pi, main_angle)

    # disc centres in level coordinates (n, 10)
    frac = (torch.arange(DIMENSION, dtype=p1.dtype, device=p1.device) + 1.0) / (DIMENSION + 1)
    cx = (p1[:, 0:1] + frac * d[:, 0:1]) / ratio[:, None]
    cy = (p1[:, 1:2] + frac * d[:, 1:2]) / ratio[:, None]

    # fixed 13 x 13 windows (n, 10, 13, 13): x along the last axis
    off = torch.arange(WIN, device=p1.device)
    bx = torch.trunc(cx - r[:, None]).to(torch.int64)
    by = torch.trunc(cy - r[:, None]).to(torch.int64)
    xs = (bx[..., None, None] + off).expand(-1, -1, WIN, -1)
    ys = (by[..., None, None] + off[:, None]).expand(-1, -1, -1, WIN)
    dist = torch.sqrt((xs - cx[..., None, None]) ** 2 + (ys - cy[..., None, None]) ** 2)
    wl, hl = w[:, None, None, None], h[:, None, None, None]
    inside = (xs >= 1) & (xs < wl - 1) & (ys >= 1) & (ys < hl - 1)
    ok = (dist <= r[:, None, None, None]) & inside
    flat = (lvl[:, None, None, None] * H + torch.clamp(ys, 0, H - 1)) * W \
        + torch.clamp(xs, 0, W - 1)
    ang = angles.reshape(-1)[flat]
    mag = mags.reshape(-1)[flat]

    rel = torch.where(ang >= 0, ang - main_angle[:, None, None, None], torch.zeros_like(ang))
    rel = _mod(rel, torch.full_like(rel, two_pi))
    gweight = torch.exp(-dist * dist / 4.5 / sigma2[:, None, None, None]) * mag * ok

    bin24 = torch.floor(rel * BINNUM / two_pi + 0.5).to(torch.int64)
    bin24 = torch.where(bin24 >= BINNUM, 0, bin24)
    bin8 = torch.floor(rel * SUBDIR / two_pi + 0.5).to(torch.int64)
    bin8 = torch.where(bin8 >= SUBDIR, 0, bin8)
    n = p1.shape[0]
    gw = gweight.reshape(n, DIMENSION, -1)
    b24 = bin24.reshape(n, DIMENSION, -1)
    b8 = bin8.reshape(n, DIMENSION, -1)
    zero = torch.zeros_like(gw)
    stat = torch.stack([torch.where(b24 == b, gw, zero).sum(-1) for b in range(BINNUM)], -1)
    desc = torch.stack([torch.where(b8 == b, gw, zero).sum(-1) for b in range(SUBDIR)], -1)

    principal = torch.argmax(stat, dim=-1)        # the first maximum on ties
    weight = torch.gather(stat, -1, principal[..., None])[..., 0]
    desc = desc.reshape(n, -1)
    total = desc.sum(-1, keepdim=True)
    desc = desc / torch.where(total == 0, torch.ones_like(total), total)
    wsum = weight.sum(-1)
    contrast = wsum / torch.clamp(distance / ratio, min=1e-12)
    weight = weight / torch.where(wsum == 0, torch.ones_like(wsum), wsum)[:, None]
    return desc, principal, weight, contrast


def vld_difference(v1, v2):
    """VLD::difference (kvld.h:100-124)."""
    d1, p1, w1, c1 = v1
    d2, p2, w2, c2 = v2
    bad = (c1 > MAX_CONTRAST) | (c2 > MAX_CONTRAST) | (c1 <= 0) | (c2 <= 0)
    diff0 = (d1 - d2).abs().sum(-1) * 0.36
    pd = (p1 - p2).abs()
    circ = torch.minimum(pd, BINNUM - pd)
    diff1 = (circ * (w1 + w2)).sum(-1) * 0.64 / BINNUM
    return torch.where(bad, torch.full_like(diff0, 128.0), diff0 + diff1)


def vld_pair_diff(pyr1, pyr2, a1, a2, b1, b2):
    """Differences (n,) between the VLDs of segments a1 -> a2 on pyramid
    pyr1 and b1 -> b2 on pyr2 (pyramid_on dicts, (n, 2) float64 tensors)."""
    return vld_difference(_vld_batch(pyr1, a1, a2), _vld_batch(pyr2, b1, b2))


# ---------------------------------------------------------------------------
# KVLD driver (kvld.cpp:195-422)
# ---------------------------------------------------------------------------

def kvld_filter(image1, image2, feats1, feats2, matches, K=3,
                inlier_rate=0.04, geometry=True, chunk=2048, device="cuda"):
    """Filter putative matches by K-VLD consistency.

    image1/2: (H, W) gray in [0, 255]; feats: dict with 'xy' (N, 2),
    'scale' (N,), 'orientation' (N,); matches: (M, 2) int indices.
    Returns (filtered_matches (M', 2), scores (M',), valid_mask (M,)).
    The VLD differences run on `device` in float64, `chunk` pairs a call."""
    matches = np.asarray(matches, np.int64).reshape(-1, 2)
    M = len(matches)
    if M == 0:
        return matches, np.zeros(0), np.zeros(0, bool)
    xy1 = np.asarray(feats1["xy"], np.float64)
    xy2 = np.asarray(feats2["xy"], np.float64)
    sc1 = np.asarray(feats1.get("scale", np.ones(len(xy1))), np.float64)
    sc2 = np.asarray(feats2.get("scale", np.ones(len(xy2))), np.float64)
    or1 = np.asarray(feats1.get("orientation", np.zeros(len(xy1))), np.float64)
    or2 = np.asarray(feats2.get("orientation", np.zeros(len(xy2))), np.float64)

    H1, W1 = np.asarray(image1).shape
    H2, W2 = np.asarray(image2).shape
    a_count = min(len(xy1), M)
    b_count = min(len(xy2), M)
    range1 = math.sqrt(3.0 * H1 * W1 / (inlier_rate * a_count * math.pi))
    range2 = math.sqrt(3.0 * H2 * W2 / (inlier_rate * b_count * math.pi))

    pa = xy1[matches[:, 0]]
    pb = xy2[matches[:, 1]]
    d1 = np.hypot(pa[:, None, 0] - pa[None, :, 0],
                  pa[:, None, 1] - pa[None, :, 1])
    d2 = np.hypot(pb[:, None, 0] - pb[None, :, 0],
                  pb[:, None, 1] - pb[None, :, 1])
    gate = ((d1 > MIN_DIST) & (d2 > MIN_DIST)
            & ((d1 < range1) | (d2 < range2)))

    iu, ju = np.triu_indices(M, k=1)
    cand = gate[iu, ju]
    iu, ju = iu[cand], ju[cand]

    if geometry and len(iu):
        geo = _consistent_matchpair(xy1, sc1, or1, xy2, sc2, or2,
                                    matches, iu, ju)
        keep = geo < DISTANCE_THRES
        iu, ju = iu[keep], ju[keep]

    # batched VLD differences over surviving candidate pairs
    E = np.full((M, M), -1.0, np.float32)
    if len(iu):
        pyr1 = pyramid_on(build_image_scale(image1), device)
        pyr2 = pyramid_on(build_image_scale(image2), device)

        def pts(xy, side, idx):
            return torch.as_tensor(xy[matches[idx, side]], device=device)

        for s in range(0, len(iu), chunk):
            sl = slice(s, s + chunk)
            diff = vld_pair_diff(pyr1, pyr2, pts(xy1, 0, iu[sl]), pts(xy1, 0, ju[sl]),
                                 pts(xy2, 1, iu[sl]), pts(xy2, 1, ju[sl])).cpu().numpy()
            ok = diff < JUGE
            E[iu[sl][ok], ju[sl][ok]] = diff[ok]
            E[ju[sl][ok], iu[sl][ok]] = diff[ok]

    # -------- fixed-point pruning (kvld.cpp:245-412) --------
    valid = np.ones(M, bool)
    consistent_m = E >= 0
    scoretable = np.zeros(M)
    result = np.zeros(M, np.int64)
    for _ in range(64):
        change = False
        vm = valid[None, :] & valid[:, None] & consistent_m
        result = vm.sum(axis=1)
        scoretable = np.where(vm, E, 0.0).sum(axis=1)
        drop = valid & (result < K)
        if drop.any():
            valid[drop] = False
            change = True
            continue
        # duplicate endpoints: keep the best by (result, then lower score)
        for side_ids in (matches[:, 0], matches[:, 1]):
            order = np.lexsort((scoretable, -result, side_ids))
            srt = order[valid[order]]
            ids = side_ids[srt]
            dup = np.zeros(len(srt), bool)
            dup[1:] = ids[1:] == ids[:-1]
            if dup.any():
                valid[srt[dup]] = False
                change = True
        if change:
            continue
        if geometry:
            vm = valid[None, :] & valid[:, None] & gate
            np.fill_diagonal(vm, False)
            geo_full = np.zeros((M, M))
            vi, vj = np.nonzero(vm)
            if len(vi):
                geo_full[vi, vj] = _consistent_matchpair(
                    xy1, sc1, or1, xy2, sc2, or2, matches, vi, vj)
            index = vm.sum(axis=1)
            good = (vm & (geo_full < DISTANCE_THRES)).sum(axis=1)
            avg = np.where(index > 0,
                           np.where(vm, geo_full, 0).sum(axis=1)
                           / np.maximum(index, 1), 0.0)
            switching = valid & (index > 0) & (good < 0.3 * index) & (avg > 1.2)
            scoretable = np.where(switching, avg, scoretable)
            if switching.any():
                valid[switching] = False
                change = True
        if not change:
            break
    sel = np.nonzero(valid)[0]
    return matches[sel], scoretable[sel], valid


def _consistent_matchpair(xy1, sc1, or1, xy2, sc2, or2, matches, i, j):
    """consistent(F1[a1], F1[a2], F2[b1], F2[b2]) for match index pairs."""
    a1, b1 = matches[i, 0], matches[i, 1]
    a2, b2 = matches[j, 0], matches[j, 1]
    ax = xy1[a1, 0] - xy1[a2, 0]
    ay = xy1[a1, 1] - xy1[a2, 1]
    bx = xy2[b1, 0] - xy2[b2, 0]
    by = xy2[b1, 1] - xy2[b2, 1]
    d_b = np.hypot(bx, by)

    def side(angle, s_ratio):
        axr = (np.cos(angle) * ax - np.sin(angle) * ay) * s_ratio
        ayr = (np.sin(angle) * ax + np.cos(angle) * ay) * s_ratio
        dd = np.hypot(axr, ayr)
        err = np.hypot(axr - bx, ayr - by)
        return err / np.maximum(np.minimum(dd, d_b), 1e-12)

    dA = side(or2[b1] - or1[a1], sc2[b1] / np.maximum(sc1[a1], 1e-12))
    dB = side(or2[b2] - or1[a2], sc2[b2] / np.maximum(sc1[a2], 1e-12))
    return np.minimum(dA, dB)
