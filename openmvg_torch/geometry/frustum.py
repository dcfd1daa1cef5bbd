"""Camera frusta and intersection tests for pair pruning (counterpart:
openmvg_tpu/geometry/frustum.py; host numpy, as there).

Reference parity: geometry/frustum.hpp:34 (pyramidal frustum as 4/5/6
half-spaces from K, R, C and optional near/far planes),
half_space_intersection.hpp (all-pairs plane tests), used by
sfm_data_filters_frustum.cpp FrustumFilter and main_FrustumFiltering.cpp
to keep only view pairs whose frusta intersect.

Implementation: frusta as corner point sets + separating-axis test on the
half-space planes (batched numpy; pair counts are small relative to the
image work).
"""

import numpy as np


def frustum_corners(K, R, C, w, h, z_near, z_far):
    """8 corner points of the frustum between z_near and z_far (world)."""
    Kinv = np.linalg.inv(K)
    corners_px = np.array([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], float)
    rays = (Kinv @ corners_px.T).T  # camera dirs
    out = []
    for z in (z_near, z_far):
        cam = rays * z  # points at depth z
        out.append(cam @ R + C)  # R^T cam... note: x_world = R^T x_cam + C
    return np.concatenate(out, axis=0)


def box_corners(bb_min, bb_max):
    """8 corners of an axis-aligned box (geometry/box.hpp Box), ordered
    bottom(4)+top(4) to match the frustum near/far corner convention, so
    the same separating-plane test covers frustum-box intersection
    (frustum_box_intersection_test.cpp)."""
    x0, y0, z0 = np.asarray(bb_min, float)
    x1, y1, z1 = np.asarray(bb_max, float)
    return np.array([
        [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
    ])


def _planes_from_frustum(corners, apex=None):
    """Outward plane normals of the convex hull of a pyramidal frustum
    given its 8 corners ordered near(4) + far(4)."""
    n0, n1, n2, n3, f0, f1, f2, f3 = corners
    center = corners.mean(axis=0)
    planes = []

    def plane(a, b, c):
        n = np.cross(b - a, c - a)
        nn = np.linalg.norm(n)
        if nn < 1e-12:
            return None
        n = n / nn
        d = -np.dot(n, a)
        if np.dot(n, center) + d > 0:  # orient outward
            n, d = -n, -d
        return np.concatenate([n, [d]])

    quads = [
        (n0, n1, n2),  # near
        (f0, f2, f1),  # far
        (n0, f0, f1), (n1, f1, f2), (n2, f2, f3), (n3, f3, f0),  # sides
    ]
    for q in quads:
        p = plane(*q)
        if p is not None:
            planes.append(p)
    return np.stack(planes)


def frusta_intersect(corners_a, corners_b):
    """Conservative separating-plane test between two convex frusta:
    intersect unless some face plane of one separates all corners of the
    other (the half_space_intersection.hpp protocol)."""
    for pa, pb in ((corners_a, corners_b), (corners_b, corners_a)):
        planes = _planes_from_frustum(pa)
        d = planes[:, :3] @ pb.T + planes[:, 3:4]
        if np.any(np.all(d > 1e-9, axis=1)):
            return False
    return True


def frustum_filter_pairs(scene, pairs, z_near=0.01, z_far=100.0):
    """Keep pairs of posed views with intersecting frusta
    (sfm_data_filters_frustum.cpp).  If the scene has structure, per-view
    depth ranges refine near/far like the reference's init."""
    from openmvg_torch.models.cameras import K_matrix_np

    corners = {}

    def get_corners(v):
        if v not in corners:
            pid = scene.view_pose[v]
            iid = scene.view_intrinsic[v]
            K = K_matrix_np(np.asarray(scene.cameras.params)[iid])
            zn, zf = z_near, z_far
            ok = (scene.obs_valid & (scene.obs_view == v)
                  & scene.X_valid[scene.obs_landmark])
            if ok.any():
                X = scene.X[scene.obs_landmark[ok]]
                zc = (X - scene.pose_C[pid]) @ scene.pose_R[pid][2]
                zc = zc[zc > 0]
                if len(zc):
                    zn, zf = float(zc.min()) * 0.9, float(zc.max()) * 1.1
            corners[v] = frustum_corners(
                K, scene.pose_R[pid], scene.pose_C[pid],
                float(scene.view_wh[v, 0]), float(scene.view_wh[v, 1]), zn, zf)
        return corners[v]

    kept = []
    for (i, j) in pairs:
        pi, pj = scene.view_pose[i], scene.view_pose[j]
        if (pi < 0 or pj < 0 or not scene.pose_valid[pi]
                or not scene.pose_valid[pj]):
            continue
        if frusta_intersect(get_corners(i), get_corners(j)):
            kept.append((i, j))
    return kept
