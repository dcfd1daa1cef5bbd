"""MSER — maximally stable extremal regions (counterpart:
openmvg_tpu/ops/mser.py, of which this is a copy: the port imports nothing
of the reference package).

Reference parity: features/mser/ (MSERExtractor over the image component
tree, bright-on-dark and dark-on-bright polarities, stability criterion
|area(t+d) - area(t-d)| / area(t), min/max area and max-variation
filters, ellipse fitting from region moments).

Host-side implementation: thresholded connected components per intensity
level via scipy.ndimage.label (C speed), component-tree linkage across
levels by representative-pixel lookup, stability minima selection.  MSER
is a sample/VO-grade detector in the reference (not the SfM hot path), so
a batched device recast is not warranted.
"""

from typing import List, NamedTuple

import numpy as np
from scipy import ndimage


class MserRegion(NamedTuple):
    cx: float
    cy: float
    area: int
    # ellipse from second moments
    major: float
    minor: float
    angle: float
    level: int
    dark: bool  # dark-on-bright (detected on the < t tree)


def detect_mser(image, delta=2, min_area=30, max_area_ratio=0.25,
                max_variation=0.5, levels=26, both_polarities=True
                ) -> List[MserRegion]:
    """image (H, W) float [0,1] or uint8.  Returns stable regions."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    out = list(_mser_one_polarity(img, delta, min_area, max_area_ratio,
                                  max_variation, levels, dark=True))
    if both_polarities:
        out += list(_mser_one_polarity(255 - img, delta, min_area,
                                       max_area_ratio, max_variation, levels,
                                       dark=False))
    return out


def _mser_one_polarity(img, delta, min_area, max_area_ratio, max_variation,
                       levels, dark):
    H, W = img.shape
    max_area = int(max_area_ratio * H * W)
    ts = np.linspace(0, 255, levels).astype(int)
    labels = []
    counts = []
    for t in ts:
        lab, n = ndimage.label(img <= t)
        labels.append(lab)
        counts.append(np.bincount(lab.ravel(), minlength=n + 1))

    # representative pixel per (level, comp): first occurrence
    reps = []
    for lab in labels:
        flat = lab.ravel()
        first = np.full(flat.max() + 1, -1, np.int64)
        idx = np.nonzero(flat)[0]
        # reversed so earlier index wins
        first[flat[idx[::-1]]] = idx[::-1]
        reps.append(first)

    # stability: region r at level i corresponds upward via its rep pixel
    regions = []
    for i in range(1, len(ts) - 1):
        lab = labels[i]
        cnt = counts[i]
        for comp in range(1, len(cnt)):
            area = cnt[comp]
            if area < min_area or area > max_area:
                continue
            rep = reps[i][comp]
            y, x = divmod(rep, W)
            comp_up = labels[i + 1][y, x]
            comp_dn = labels[i - 1][y, x]
            area_up = counts[i + 1][comp_up] if comp_up > 0 else area
            area_dn = counts[i - 1][comp_dn] if comp_dn > 0 else 0
            var = (area_up - area_dn) / max(area, 1)
            if var < max_variation:
                regions.append((i, comp, area, var))

    # keep local stability minima along each branch: greedy — sort by var,
    # suppress overlapping ancestors/descendants via rep-pixel identity
    regions.sort(key=lambda r: r[3])
    taken = np.zeros_like(labels[0], bool)
    out = []
    for (i, comp, area, var) in regions:
        mask = labels[i] == comp
        if taken[mask].mean() > 0.3:
            continue
        taken |= mask
        ys, xs = np.nonzero(mask)
        cx, cy = xs.mean(), ys.mean()
        u20 = ((xs - cx) ** 2).mean()
        u02 = ((ys - cy) ** 2).mean()
        u11 = ((xs - cx) * (ys - cy)).mean()
        tr = u20 + u02
        det = u20 * u02 - u11 * u11
        l1 = tr / 2 + np.sqrt(max(tr * tr / 4 - det, 0))
        l2 = tr / 2 - np.sqrt(max(tr * tr / 4 - det, 0))
        angle = 0.5 * np.arctan2(2 * u11, u20 - u02)
        out.append(MserRegion(cx=float(cx), cy=float(cy), area=int(area),
                              major=2.0 * np.sqrt(max(l1, 0)),
                              minor=2.0 * np.sqrt(max(l2, 0)),
                              angle=float(angle), level=int(ts[i]),
                              dark=dark))
    return out
