"""Synthetic multi-view datasets (counterpart: openmvg_tpu/utils/synthetic.py:
ring_scene, bearings_of, render_blob_dataset, render_textured_sphere_dataset,
big_ba_problem and the camera helper they need), and SPHERICAL scenes on
the same camera ring: the reference test's 6-view scene
(tests/test_spherical_sfm.py) and a 360-degree room of a size users record,
written as the CLI's files."""

import os
from typing import NamedTuple

import numpy as np
import torch

from openmvg_torch.io.gt_loaders import write_strecha_camera
from openmvg_torch.io.image import write_image
from openmvg_torch.models import cameras as cm
from openmvg_torch.sfm.scene import Scene


def _look_at(center, target, up=(0.0, 1e-6, 1.0)):
    """World->camera R with +z toward target, y roughly down."""
    z = np.asarray(target, float) - center
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, float), z)
    if np.linalg.norm(x) < 1e-9:
        x = np.cross([1.0, 0.0, 0.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)


class NViewScene(NamedTuple):
    K: np.ndarray        # (V, 3, 3)
    R: np.ndarray        # (V, 3, 3) world->cam
    t: np.ndarray        # (V, 3)
    C: np.ndarray        # (V, 3) camera centres
    X: np.ndarray        # (P, 3) world points
    x: np.ndarray        # (V, P, 2) pixel projections
    visible: np.ndarray  # (V, P) bool (in front and in the image)

    @property
    def n_views(self):
        return self.R.shape[0]

    @property
    def n_points(self):
        return self.X.shape[0]


def _ring(n_views, radius):
    """The ring of test_data_sets.cpp NRealisticCamerasRing: centres, and
    world->camera rotations looking at the origin."""
    theta = 2 * np.pi * np.arange(n_views) / n_views
    C = np.stack([radius * np.cos(theta), 0.2 * np.sin(theta * 2), radius * np.sin(theta)], 1)
    return C, np.stack([_look_at(c, [0.0, 0.0, 0.0]) for c in C])


def ring_scene(n_views=12, n_points=100, focal=1000.0, width=1000, height=1000,
               radius=2.0, seed=0, jitter=0.0):
    """Pinhole cameras on a ring of `radius` viewing a unit point cloud at
    the origin (test_data_sets.cpp NRealisticCamerasRing)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-0.5, 0.5, size=(n_points, 3))
    K = np.zeros((n_views, 3, 3))
    K[:] = np.array([[focal, 0, width / 2.0], [0, focal, height / 2.0], [0, 0, 1]])
    C, R = _ring(n_views, radius)
    t = -np.einsum("vij,vj->vi", R, C)
    Xc = np.einsum("vij,pj->vpi", R, X) + t[:, None, :]
    proj = Xc[..., :2] / Xc[..., 2:3]
    x = np.einsum("vij,vpj->vpi", K[:, :2, :2], proj) + K[:, None, :2, 2]
    if jitter > 0:
        x = x + rng.normal(scale=jitter, size=x.shape)
    visible = ((Xc[..., 2] > 0) & (x[..., 0] >= 0) & (x[..., 0] < width)
               & (x[..., 1] >= 0) & (x[..., 1] < height))
    return NViewScene(K=K, R=R, t=t, C=C, X=X, x=x, visible=visible)


def bearings_of(scene, view, idx=None):
    """Unit bearings of a pinhole view's pixel observations (numpy)."""
    x = scene.x[view] if idx is None else scene.x[view][idx]
    K = scene.K[view]
    p = (x - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])
    b = np.concatenate([p, np.ones_like(p[:, :1])], axis=1)
    return b / np.linalg.norm(b, axis=1, keepdims=True)


def render_blob_dataset(out_dir, n_views=6, n_points=400, size=320, focal=400.0, seed=0,
                        arc_step=0.12, flatten=0.4):
    """Render random Gaussian intensity blobs seen from a camera arc
    (arc_step radians between views), with Strecha-format ground truth.
    flatten < 1 squeezes the cloud toward the z = 0 plane; "ball" makes a
    shell seen alike from every ring angle.  Writes
    out_dir/images/img_XX.png and out_dir/gt/img_XX.png.camera; returns
    (imgdir, gtdir, Rs, Cs, K).  Host numpy, the reference's draws."""
    rng = np.random.default_rng(seed)
    if flatten == "ball":
        d = rng.normal(size=(n_points, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        X = d * rng.uniform(0.35, 0.9, (n_points, 1))
    else:
        X = rng.uniform(-0.9, 0.9, size=(n_points, 3))
        X[:, 2] *= flatten
    intens = rng.uniform(0.3, 1.0, n_points)
    radii = rng.uniform(1.2, 2.8, n_points)
    K = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1.0]])
    imgdir = os.path.join(out_dir, "images")
    gtdir = os.path.join(out_dir, "gt")
    os.makedirs(imgdir, exist_ok=True)
    os.makedirs(gtdir, exist_ok=True)
    Rs, Cs = [], []
    W = 17  # blob window half-extent (covers 4 r at r <= 4)
    PAD = W + 6
    win = np.arange(-W, W + 1, dtype=np.float32)
    for v in range(n_views):
        theta = (v - n_views / 2) * arc_step
        C = np.array([3.0 * np.sin(theta), 0.3 * np.sin(2 * theta), -3.0 * np.cos(theta)])
        R = _look_at(C, [0.0, 0.0, 0.0])
        Rs.append(R)
        Cs.append(C)
        Xc = (X - C) @ R.T
        z = Xc[:, 2]
        uv = (Xc[:, :2] / np.where(np.abs(z) < 1e-9, 1e-9, z)[:, None]) * focal + size / 2
        img = np.zeros((size + 2 * PAD, size + 2 * PAD), np.float32)
        ok = (z > 0.5) & (uv[:, 0] > -5) & (uv[:, 0] < size + 5) \
            & (uv[:, 1] > -5) & (uv[:, 1] < size + 5)
        r_all = np.clip(radii * focal / (np.maximum(z, 0.5) * 130.0) * 40.0, 1.0, 4.0)
        for p in np.nonzero(ok)[0]:
            u, v2 = uv[p]
            iu, iv = int(round(u)), int(round(v2))
            gy = np.exp(-((win + iv - v2) ** 2) / (2 * r_all[p] ** 2))
            gx = np.exp(-((win + iu - u) ** 2) / (2 * r_all[p] ** 2))
            img[iv + PAD - W: iv + PAD + W + 1,
                iu + PAD - W: iu + PAD + W + 1] += intens[p] * np.outer(gy, gx)
        img = np.clip(img[PAD: PAD + size, PAD: PAD + size], 0, 1)
        name = f"img_{v:02d}.png"
        write_image(os.path.join(imgdir, name), img)
        write_strecha_camera(os.path.join(gtdir, name + ".camera"), K, R, C, (size, size))
    return imgdir, gtdir, np.stack(Rs), np.stack(Cs), K


def big_ba_problem(n_poses=256, n_points=300_000, obs_per_point=14, seed=0, noise_px=0.5,
                   noise_X=0.01, dtype=torch.float32, device="cpu"):
    """A large, geometrically consistent BA problem built observation table
    first: cameras on a ring of radius 3 looking at the origin, each point
    seen from obs_per_point poses within 32 ring steps, one shared PINHOLE
    (f 1000, principal point (500, 500)), 0.5 px pixel noise and points
    perturbed by noise_X.  The numpy draws are the reference's, so one seed
    gives the reference's problem; the observations take the port's
    point-major layout (without the reference's rows of padding).  Returns
    (sfm.ba.BAProblem on `device`, number of observations)."""
    from openmvg_torch.sfm import ba
    from openmvg_torch.utils.hostmath import logmap_np

    rng = np.random.default_rng(seed)
    theta = np.linspace(0, 2 * np.pi, n_poses, endpoint=False)
    C = np.stack([3 * np.cos(theta), 3 * np.sin(theta), 0.2 * np.sin(3 * theta)], 1)
    R = np.stack([_look_at(c, [0.0, 0.0, 0.0]) for c in C])
    X = rng.uniform(-1, 1, (n_points, 3)) * [1.0, 1.0, 0.4]
    base = rng.integers(0, n_poses, n_points)
    offs = rng.integers(0, 32, (n_points, obs_per_point))
    pose_id = ((base[:, None] + offs) % n_poses).reshape(-1)
    point_id = np.repeat(np.arange(n_points), obs_per_point)
    f, cx, cy = 1000.0, 500.0, 500.0
    Xc = np.einsum("oij,oj->oi", R[pose_id], X[point_id] - C[pose_id])
    x = Xc[:, :2] / Xc[:, 2:] * f + [cx, cy]
    x = x + rng.normal(scale=noise_px, size=x.shape)
    O = len(pose_id)
    X0 = X + rng.normal(scale=noise_X, size=X.shape)
    obs_pose, obs_intr, obs_point, obs_x, obs_w, table = ba.point_major_layout(
        pose_id, np.zeros(O, np.int64), point_id, x, np.ones(O), n_points)
    fields = dict(obs_pose=obs_pose, obs_intr=obs_intr, obs_point=obs_point, obs_x=obs_x,
                  obs_w=obs_w, rotvec=logmap_np(R), t=-np.einsum("nij,nj->ni", R, C),
                  intr_kind=np.asarray([cm.PINHOLE]), intr_wh=np.asarray([[1000, 1000]]),
                  intr_params=np.asarray([[f, cx, cy, 0, 0, 0, 0, 0]]), X=X0,
                  mask_pose=np.ones((n_poses, 6)), mask_intr=np.zeros((1, 8)),
                  mask_X=np.ones(n_points), prior_C=np.zeros((n_poses, 3)),
                  prior_w=np.zeros((n_poses, 3)), pt_obs=table)
    return ba.problem_from_reference(fields, dtype, device), O


def _spherical_scene(n_views, width, height):
    """A Scene of n_views views sharing one SPHERICAL intrinsic, no pose."""
    sc = Scene()
    sc.view_filename = [f"v{i}.jpg" for i in range(n_views)]
    sc.view_intrinsic = np.zeros(n_views, np.int32)
    sc.view_pose = np.arange(n_views, dtype=np.int32)
    sc.view_wh = np.tile([[width, height]], (n_views, 1)).astype(np.int32)
    sc.cameras = cm.Cameras(kind=np.array([cm.SPHERICAL], np.int32),
                            width=np.array([float(width)]), height=np.array([float(height)]),
                            params=np.zeros((1, cm.MAX_PARAMS)))
    sc.pose_valid = np.zeros(n_views, bool)
    sc.pose_R = np.tile(np.eye(3), (n_views, 1, 1))
    sc.pose_C = np.zeros((n_views, 3))
    return sc


def project_spherical(R, C, X, width, height, device="cpu"):
    """Equirectangular pixels (N, 2) of points X (N, 3) in cameras (R (N, 3,
    3) world->cam, C (N, 3)): one float64 projection call on `device`."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    Xc = torch.einsum("nij,nj->ni", t(R), t(X) - t(C))
    n = Xc.shape[0]
    px = cm.project_cam(torch.full((n,), cm.SPHERICAL, device=device),
                        torch.zeros((n, cm.MAX_PARAMS), dtype=torch.float64, device=device),
                        t(np.full(n, float(width))), t(np.full(n, float(height))), Xc)
    return px.cpu().numpy()


def spherical_ring_scene(n_views=6, n_points=150, seed=0, width=2048, height=1024):
    """The reference test's spherical scene (tests/test_spherical_sfm.py
    _spherical_scene_and_data): ring_scene's cameras and points, one
    SPHERICAL intrinsic, every point a feature of every view, and each view
    matched to the next two.  Returns (ring scene, Scene, feats, matches)."""
    s = ring_scene(n_views=n_views, n_points=n_points, seed=seed)
    sc = _spherical_scene(n_views, width, height)
    v, p = np.divmod(np.arange(n_views * n_points), n_points)
    px = project_spherical(s.R[v], s.C[v], s.X[p], width, height).reshape(n_views, n_points, 2)
    feats = list(px)
    every = np.stack([np.arange(n_points)] * 2, axis=1)
    matches = {(i, j): every.copy() for i in range(n_views)
               for j in range(i + 1, min(i + 3, n_views))}
    return s, sc, feats, matches


def spherical_room_dataset(out_dir, n_views=100, width=5376, height=2688, n_obs=300_000,
                           radius=2.0, max_step=3, noise_px=0.5, outlier_share=0.1, seed=0,
                           device="cpu"):
    """A 360-degree camera walked around a room: n_views equirectangular
    views of width x height on the reference ring (radius `radius`,
    ring_scene's layout) and points on the room's surroundings, 3 to 6
    units from its centre and up to 1.5 above or below, with pixel noise
    noise_px.  Each point is seen by the 2h + 1 views nearest it in
    azimuth, h drawn from 2..8 (at most (n_views - 1) // 2), about n_obs
    observations in all: short tracks, as features that stop matching, so
    that the views are chained around the ring and the last ones close the
    loop.  Every
    pair of a point's views up to max_step ring steps apart is matched, and
    outlier_share of the matches are replaced by random features of the
    second view: putative matches, for a geometric filter to clean.

    Writes out_dir/sfm_data.json (one SPHERICAL intrinsic, no pose),
    out_dir/matches/v<i>.feat and .desc (zero descriptors) and
    out_dir/matches/matches.putative.bin.  Returns (sfm_data path, matches
    directory, ground-truth R (V, 3, 3), ground-truth C (V, 3))."""
    from openmvg_torch.io.features_io import save_descs, save_feats
    from openmvg_torch.io.matches_io import save_matches
    from openmvg_torch.io.sfm_data import save_sfm_data

    rng = np.random.default_rng(seed)
    C, R = _ring(n_views, radius)
    lo, hi = min(2, (n_views - 1) // 2), min(8, (n_views - 1) // 2)
    half = rng.integers(lo, hi + 1, size=max(1, n_obs // (lo + hi + 1)))
    n_pts = len(half)
    phi = rng.uniform(0, 2 * np.pi, n_pts)
    dist = rng.uniform(3.0, 6.0, n_pts)
    X = np.stack([dist * np.cos(phi), rng.uniform(-1.5, 1.5, n_pts), dist * np.sin(phi)], 1)
    # the views of each point, consecutive: a = 0 .. 2h around the nearest
    length = 2 * half + 1
    start = np.rint(phi / (2 * np.pi / n_views)).astype(np.int64) - half
    obs_pt = np.repeat(np.arange(n_pts), length)
    a = np.arange(len(obs_pt)) - np.repeat(np.cumsum(length) - length, length)
    obs_view = (np.repeat(start, length) + a) % n_views
    px = project_spherical(R[obs_view], C[obs_view], X[obs_pt], width, height, device)
    px = px + rng.normal(scale=noise_px, size=px.shape)
    px[:, 0] %= width   # a feature lies in the panorama, across its seam too
    # feature ids: the observations of a view, in point order
    order = np.lexsort((obs_pt, obs_view))
    counts = np.bincount(obs_view, minlength=n_views)
    first = np.cumsum(counts) - counts
    feat = np.empty(len(obs_pt), np.int64)
    feat[order] = np.arange(len(obs_pt)) - np.repeat(first, counts)

    md = os.path.join(out_dir, "matches")
    os.makedirs(md, exist_ok=True)
    sc = _spherical_scene(n_views, width, height)
    sc.root_path = os.path.join(out_dir, "images")
    for v in range(n_views):
        sel = order[first[v]:first[v] + counts[v]]
        save_feats(os.path.join(md, f"v{v}.feat"), np.c_[px[sel], np.ones(len(sel)),
                                                        np.zeros(len(sel))])
        save_descs(os.path.join(md, f"v{v}.desc"), np.zeros((len(sel), 128), np.uint8))
    # every pair of a point's views up to max_step ring steps apart
    rows = []
    for k in range(1, max_step + 1):
        o = np.nonzero(a + k < np.repeat(length, length))[0]
        vi, vj, fi, fj = obs_view[o], obs_view[o + k], feat[o], feat[o + k]
        swap = vi > vj
        rows.append(np.stack([np.where(swap, vj, vi), np.where(swap, vi, vj),
                              np.where(swap, fj, fi), np.where(swap, fi, fj)], 1))
    rows = np.concatenate(rows)
    rows = rows[np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))]
    out = rng.random(len(rows)) < outlier_share
    n_j = counts[rows[out, 1]]
    rows[out, 3] = (rows[out, 3] + rng.integers(1, n_j)) % n_j
    cut = np.nonzero(np.diff(rows[:, 0] * n_views + rows[:, 1]))[0] + 1
    matches = {(int(r[0, 0]), int(r[0, 1])): r[:, 2:4] for r in np.split(rows, cut)}
    save_matches(matches, os.path.join(md, "matches.putative.bin"))
    sfm = os.path.join(out_dir, "sfm_data.json")
    save_sfm_data(sc, sfm)
    return sfm, md, R, C


def render_textured_sphere_dataset(out_dir, n_views=100, size=1024,
                                   focal=None, seed=0, radius=1.4,
                                   cam_radius=3.0, n_waves=96,
                                   freq_hi=400.0, arc_step=None, thetas=None,
                                   device="cuda"):
    """Ray-cast a procedurally textured sphere from a camera ring.

    Each pixel's ray meets a sphere, shaded by a sum of random 3D sinusoids
    evaluated at the 3D hit point: dense, unique texture that is exactly
    consistent across views.  The random scene comes from numpy with
    `seed`, as in the reference; the shading runs in float64 on `device`.
    Writes out_dir/images/img_XX.png and Strecha-format ground truth in
    out_dir/gt; returns (imgdir, gtdir, Rs, Cs, K).  View v sits at ring
    angle (v - n_views / 2) * arc_step (2 pi / n_views by default), or at
    thetas[v] when `thetas` is given (then len(thetas) views): held-out
    views of the same world."""
    rng = np.random.default_rng(seed)
    focal = focal or size * 1.2
    freqs = np.exp(rng.uniform(np.log(3.0), np.log(freq_hi), n_waves))
    dirs = rng.normal(size=(n_waves, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    kvecs = dirs * freqs[:, None]
    phases = rng.uniform(0, 2 * np.pi, n_waves)
    amps = freqs ** -0.25
    amps /= np.sqrt(np.sum(amps * amps) / 2.0)  # sum of sines -> RMS 1
    amps *= 0.42

    K = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1.0]])
    imgdir = os.path.join(out_dir, "images")
    gtdir = os.path.join(out_dir, "gt")
    os.makedirs(imgdir, exist_ok=True)
    os.makedirs(gtdir, exist_ok=True)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    kv, ph, am = t(kvecs), t(phases), t(amps)
    g = torch.arange(size, dtype=torch.float64, device=device) + 0.5
    yy, xx = torch.meshgrid(g, g, indexing="ij")
    ray_cam = torch.stack([(xx - size / 2) / focal, (yy - size / 2) / focal,
                           torch.ones_like(xx)], dim=-1)

    step = arc_step if arc_step is not None else 2 * np.pi / n_views
    if thetas is None:
        thetas = [(v - n_views / 2) * step for v in range(n_views)]
    Rs, Cs = [], []
    for v, theta in enumerate(thetas):
        C = np.array([cam_radius * np.sin(theta), 0.3 * np.sin(2 * theta),
                      -cam_radius * np.cos(theta)])
        R = _look_at(C, [0.0, 0.0, 0.0])
        Rs.append(R)
        Cs.append(C)
        Ct = t(C)
        d = ray_cam @ t(R)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        b = d @ Ct
        disc = b * b - (Ct @ Ct - radius * radius)
        hit = disc > 0
        tt = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        P = Ct + tt[..., None] * d
        tex = torch.sin(P @ kv.T + ph) @ am
        img = torch.where(hit, 0.5 + tex, torch.zeros_like(tex)).to(torch.float32)
        img = torch.clamp(img, 0, 1).cpu().numpy()
        name = f"img_{v:02d}.png"
        write_image(os.path.join(imgdir, name), img)
        write_strecha_camera(os.path.join(gtdir, name + ".camera"),
                             K, R, C, (size, size))
    return imgdir, gtdir, np.stack(Rs), np.stack(Cs), K
