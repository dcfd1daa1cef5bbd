"""2D convex hulls and convex-polygon predicates (counterpart, copied:
openmvg_tpu/geometry/convex_hull.py).

Reference parity: openMVG geometry/convex_hull.hpp — ComputeConvexHull
(Andrew's monotone chain), ConvexPolygonArea (shoelace determinant) and
IsIn (same-side test against every edge).  A standalone geometry utility
in the reference (no pipeline consumers beyond its tests); host-side
numpy here — hull sizes are tiny and the sort-based algorithm is not a
device workload.

Conventions match the reference: polygons are counter-clockwise, the hull
closes on itself (last point == first point), and a positive shoelace
area means CCW.
"""

import numpy as np


def _cross(o, a, b):
    """z of (a-o) x (b-o): >0 means b is left of the ray o->a (CCW turn)."""
    return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])


def compute_convex_hull(points):
    """Convex hull of a 2D point set (monotone chain, O(n log n)).

    points: (N, 2) array-like.  Returns an (H, 2) float64 array in CCW
    order with the first point repeated at the end (reference
    ComputeConvexHull contract, convex_hull.cpp).  Degenerate inputs
    (empty / single point / collinear) return what the reference does:
    the 0- or 1-point set, or the 2 extreme points, closed.
    """
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    # unique + lexicographic sort, as monotone chain requires
    if pts.shape[0] == 0:
        return pts
    pts = np.unique(pts, axis=0)  # sorts lexicographically (x, then y)
    n = pts.shape[0]
    if n == 1:
        return pts
    lower = []
    for p in pts:
        while len(lower) >= 2 and _cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper = []
    for p in pts[::-1]:
        while len(upper) >= 2 and _cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    hull = lower[:-1] + upper[:-1]
    hull.append(hull[0])  # close the polygon
    return np.asarray(hull)


def convex_polygon_area(polygon):
    """Shoelace area of a convex polygon (ConvexPolygonArea).

    polygon: (H, 2), closed or open — the formula wraps around either
    way.  Positive for CCW.  Polygons with <3 distinct points have
    area 0.
    """
    poly = np.asarray(polygon, dtype=np.float64).reshape(-1, 2)
    if poly.shape[0] >= 2 and np.allclose(poly[0], poly[-1]):
        poly = poly[:-1]
    if poly.shape[0] < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def is_in(point, convex_polygon):
    """True if `point` lies inside (or on) a convex CCW polygon (IsIn).

    Same-side test: the cross product against every directed edge must be
    non-negative for a CCW polygon.
    """
    poly = np.asarray(convex_polygon, dtype=np.float64).reshape(-1, 2)
    if poly.shape[0] >= 2 and np.allclose(poly[0], poly[-1]):
        poly = poly[:-1]
    if poly.shape[0] < 3:
        # a 0/1/2-point "polygon" has no area: nothing is inside
        # (reference ConvexHull.Line test expects false on the segment
        # endpoints themselves)
        return False
    p = np.asarray(point, dtype=np.float64)
    a = poly
    b = np.roll(poly, -1, axis=0)
    cross = (b[:, 0] - a[:, 0]) * (p[1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (
        p[0] - a[:, 0])
    return bool(np.all(cross >= -1e-12))
