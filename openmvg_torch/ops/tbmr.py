"""TBMR — tree-based Morse regions (counterpart: openmvg_tpu/ops/tbmr.py).

Reference parity: features/tbmr/tbmr.{hpp,cpp} (Xu, Monasse, Geraud,
Najman): the exact max-tree (union-find over brightness-sorted pixels,
4-connectivity) with incremental area and moment attributes,
canonisation, then per critical branch the largest region that preserves
topology; the ellipse from second moments, thin or tiny ones rejected
(minor semi-axis >= 1.5), both polarities (bright and dark).

The component tree is a sequential pointer-chasing algorithm: it runs on
the host, in the port's copy of the reference's native code
(csrc/native.cpp omt_tbmr, built with g++ at first use; a failed build
raises).  _tbmr_python is its plain version, for the tests.
"""

import math
from typing import List, NamedTuple

import numpy as np

from openmvg_torch.utils.build import host_library


class TbmrRegion(NamedTuple):
    x: float
    y: float
    a: float
    b: float
    c: float       # ellipse: a(dx)^2 + 2b dx dy + c(dy)^2 = 1
    l1: float      # minor semi-axis
    l2: float      # major semi-axis
    orientation: float
    area: int
    dark: bool


def _ellipse_axes(a, b, c):
    """(l1, l2, phi) from the conic params (features/feature.cpp:104-128)."""
    disc = math.sqrt(max(a * a + c * c + 4 * b * b - 2 * a * c, 0.0))
    e1 = (a + c - disc) / 2.0
    e2 = (a + c + disc) / 2.0
    l1 = 1.0 / math.sqrt(max(e1, 1e-30))
    l2 = 1.0 / math.sqrt(max(e2, 1e-30))
    if b == 0:
        phi = math.pi / 2 if a > c else 0.0
    else:
        t = math.atan(2 * b / (a - c)) if a != c else math.pi / 2
        if a < c:
            phi = t / 2
        else:
            phi = t / 2 + (-math.pi / 2 if b > 0 else math.pi / 2)
    if l1 > l2:
        l1, l2 = l2, l1
        phi = math.pi / 2 - phi
    return l1, l2, phi


def _tbmr_python(img, invert, min_size, max_rel_size):
    """The plain version of omt_tbmr (same algorithm, small images only),
    which the tests hold the native one against."""
    h, w = img.shape
    n = h * w
    key = (255 - img) if invert else img
    S = np.argsort(key.ravel(), kind="stable")
    parent = np.arange(n)
    zpar = np.arange(n)
    comp_root = np.arange(n)
    rank = np.zeros(n, np.int32)
    seen = np.zeros(n, bool)
    area = np.zeros(n, np.int64)
    mom = np.zeros((n, 5))  # sx, sy, sxx, syy, sxy
    flat = img.ravel()

    def zfind(p):
        while zpar[p] != p:
            zpar[p] = zpar[zpar[p]]
            p = zpar[p]
        return p

    for p in S[::-1]:
        p = int(p)
        seen[p] = True
        px, py = p % w, p // w
        area[p] = 1
        mom[p] = (px, py, px * px, py * py, px * py)
        x = p
        nbs = []
        if py > 0:
            nbs.append(p - w)
        if py + 1 < h:
            nbs.append(p + w)
        if px > 0:
            nbs.append(p - 1)
        if px + 1 < w:
            nbs.append(p + 1)
        for q in nbs:
            if not seen[q]:
                continue
            r = zfind(q)
            if r == x:
                continue
            parent[comp_root[r]] = p
            area[p] += area[comp_root[r]]
            mom[p] += mom[comp_root[r]]
            if rank[x] < rank[r]:
                zpar[x] = r
                comp_root[r] = p
                x = r
            elif rank[r] < rank[x]:
                zpar[r] = x
            else:
                zpar[r] = x
                rank[x] += 1
    for p in S:
        p = int(p)
        q = parent[p]
        if flat[parent[q]] == flat[q]:
            parent[p] = parent[q]
    num_sons = np.zeros(n, np.int32)
    nodes = []
    for p in S[::-1]:
        p = int(p)
        if parent[p] == p or flat[p] != flat[parent[p]]:
            nodes.append(p)
            if area[p] >= min_size:
                num_sons[parent[p]] += 1
    is_pol = np.zeros(n, bool)
    for p in nodes:
        if num_sons[p] == 0 and num_sons[parent[p]] == 1:
            is_pol[parent[p]] = True
    max_area = max_rel_size * n
    visited = np.zeros(n, bool)
    rows = []
    for p in nodes:
        if num_sons[p] != 1 or visited[p] or area[p] > max_area:
            continue
        pt, po, anc = p, p, 0
        while num_sons[pt] == 1 and area[pt] <= max_area:
            visited[pt] = True
            anc += 1
            po = pt
            pt = parent[pt]
        if is_pol[p] and anc <= 1:
            continue
        A = float(area[po])
        cx, cy = mom[po][0] / A, mom[po][1] / A
        i20 = mom[po][2] - A * cx * cx
        i02 = mom[po][3] - A * cy * cy
        i11 = mom[po][4] - A * cx * cy
        det = i20 * i02 - i11 * i11
        if det == 0:
            continue
        a = i02 / det * (A - 1) / 4
        b = -i11 / det * (A - 1) / 4
        c = i20 / det * (A - 1) / 4
        l1, _, _ = _ellipse_axes(a, b, c)
        if l1 < 1.5:
            continue
        rows.append((cx, cy, a, b, c, A))
    return np.array(rows).reshape(-1, 6)


def tbmr_native(img_u8, invert, min_size, max_rel_size, max_out=8192):
    """csrc/native.cpp omt_tbmr: (N, 6) rows (x, y, a, b, c, area) of
    the regions of a (H, W) uint8 image, at most max_out."""
    lib = host_library()
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    h, w = img_u8.shape
    out = np.empty((max_out, 6), np.float64)
    m = lib.omt_tbmr(img_u8.ravel(), w, h, 1 if invert else 0, int(min_size),
                     float(max_rel_size), out.ravel(), max_out)
    if m < 0:
        raise RuntimeError(f"omt_tbmr returned {m}")
    return out[:m]


def detect_tbmr(image, min_size=30, max_rel_size=0.01,
                both_polarities=True) -> List[TbmrRegion]:
    """image: (H, W) float [0,1] or uint8.  Defaults per tbmr.hpp:44-46
    (minimumSize=30, maximumRelativeSize=0.01)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(np.asarray(img, np.float64) * 255.0, 0, 255).astype(np.uint8)
    out: List[TbmrRegion] = []
    polarities = (False, True) if both_polarities else (False,)
    for dark in polarities:
        rows = tbmr_native(img, dark, min_size, max_rel_size)
        for (x, y, a, b, c, A) in rows:
            l1, l2, phi = _ellipse_axes(a, b, c)
            out.append(TbmrRegion(float(x), float(y), float(a), float(b),
                                  float(c), l1, l2, phi, int(A), dark))
    return out
