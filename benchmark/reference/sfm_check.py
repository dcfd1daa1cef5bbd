"""Plain checks of a reconstruction against the scene the benchmark
rendered (numpy, float64).  It reads the program's output files as
openMVG defines them (sfm_data.json, matches .bin, .feat) and imports
nothing of the program.

  epi_bad_share   share of the filtered matches that lie more than 4 px
                  from the true epipolar line (F from the rendered K, R, C)
  unposed         views of the scene without a pose
  pose_rmse       camera centres' RMSE after the 7-DoF similarity that
                  best maps them onto the rendered ones (ring radius 3)
  reproj_rmse_px  RMSE of every landmark observation's reprojection
                  (PINHOLE_CAMERA_RADIAL3 and its kin: f, principal
                  point, k1 k2 k3), worked out again from the scene file
  ba_excess       how far the bundle adjuster left the scene from its
                  minimum: (C - C*) / C*, C the robust reprojection cost
                  of the scene as written (float64) and C* the cost after
                  the plain float64 LM of reference/bal_lm.py, started
                  there, over poses and points (intrinsics held)
"""

import json
import os
import struct

import numpy as np


def _data(value):
    return value["ptr_wrapper"]["data"] if "ptr_wrapper" in value else value


def load_scene(path):
    """dict(views {id_view: (filename, id_intrinsic, id_pose)}, intrinsics
    {id: (f, cx, cy, k1, k2, k3)}, poses {id: (R, C)}, X (L, 3), obs
    (view (N,), landmark (N,), x (N, 2)))."""
    with open(path) as f:
        doc = json.load(f)
    views = {}
    for v in doc["views"]:
        d = _data(v["value"])
        views[int(v["key"])] = (d["filename"], d["id_intrinsic"], d["id_pose"])
    intr = {}
    for e in doc["intrinsics"]:
        d = _data(e["value"])
        disto = (d.get("disto_k3") or d.get("disto_k1") or []) + [0.0, 0.0, 0.0]
        intr[int(e["key"])] = (d["focal_length"], *d["principal_point"], *disto[:3])
    poses = {int(e["key"]): (np.asarray(e["value"]["rotation"], float),
                             np.asarray(e["value"]["center"], float))
             for e in doc["extrinsics"]}
    X, ov, ol, ox = [], [], [], []
    for i, e in enumerate(doc["structure"]):
        X.append(e["value"]["X"])
        for o in e["value"]["observations"]:
            ov.append(int(o["key"]))
            ol.append(i)
            ox.append(o["value"]["x"])
    return dict(views=views, intrinsics=intr, poses=poses, X=np.asarray(X, float).reshape(-1, 3),
                obs=(np.asarray(ov, np.int64), np.asarray(ol, np.int64),
                     np.asarray(ox, float).reshape(-1, 2)))


def load_matches(path):
    """openMVG's binary PairWiseMatches -> {(i, j): (n, 2) int64}."""
    with open(path, "rb") as f:
        data = f.read()
    (n_pairs,) = struct.unpack_from("<Q", data, 1)
    pos, out = 9, {}
    for _ in range(n_pairs):
        i, j, n = struct.unpack_from("<IIQ", data, pos)
        pos += 16
        out[(i, j)] = np.frombuffer(data, np.uint32, 2 * n, pos).reshape(n, 2).astype(np.int64)
        pos += 8 * n
    return out


def load_feats(path):
    """A .feat file's (N, 2) positions (x y scale orientation rows)."""
    if os.path.getsize(path) == 0:
        return np.zeros((0, 2))
    return np.loadtxt(path, dtype=np.float64, ndmin=2)[:, :2]


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def fundamental(K, Ri, Ci, Rj, Cj):
    """F with x_j^T F x_i = 0 for pixels of views i and j (world -> camera R)."""
    R = Rj @ Ri.T
    t = Rj @ (Ci - Cj)
    Ki = np.linalg.inv(K)
    return Ki.T @ _skew(t) @ R @ Ki


def epipolar_px(F, xi, xj):
    """Distance (px) of each x_j from the epipolar line F x_i."""
    hi = np.c_[xi, np.ones(len(xi))]
    hj = np.c_[xj, np.ones(len(xj))]
    line = hi @ F.T
    return np.abs((line * hj).sum(1)) / np.hypot(line[:, 0], line[:, 1])


def epi_bad_share(matches, feats, K, R, C, px=4.0):
    """Share of all filtered matches farther than px from their true line
    (a distance that is not a number counts as far); 1.0 when there are
    none."""
    bad = total = 0
    for (i, j), m in matches.items():
        d = epipolar_px(fundamental(K, R[i], C[i], R[j], C[j]), feats[i][m[:, 0]],
                        feats[j][m[:, 1]])
        bad += int((~(d <= px)).sum())
        total += len(d)
    return bad / total if total else 1.0


def similarity(src, dst):
    """Umeyama: (s, R, t) minimising |s R src + t - dst|^2."""
    ms, md = src.mean(0), dst.mean(0)
    a, b = src - ms, dst - md
    U, S, Vt = np.linalg.svd(b.T @ a / len(src))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / (a * a).sum(1).mean()
    return s, R, md - s * R @ ms


def pose_errors(scene, names, C_true):
    """(unposed views, centre RMSE after alignment; inf with < 3 posed)."""
    est, ref = [], []
    by_name = {fn: (ii, ip) for fn, ii, ip in scene["views"].values()}
    for v, name in enumerate(names):
        ip = by_name.get(name, (None, None))[1]
        if ip is not None and ip in scene["poses"]:
            est.append(scene["poses"][ip][1])
            ref.append(C_true[v])
    unposed = len(names) - len(est)
    if len(est) < 3:
        return unposed, float("inf")
    est, ref = np.asarray(est), np.asarray(ref)
    s, R, t = similarity(est, ref)
    return unposed, float(np.sqrt((((s * est @ R.T + t) - ref) ** 2).sum(1).mean()))


def reproj_rmse_px(scene):
    """RMSE (px) of every observation of every landmark; inf without any."""
    ov, ol, ox = scene["obs"]
    if len(ov) == 0:
        return float("inf")
    views = scene["views"]
    R = np.stack([scene["poses"][views[v][2]][0] for v in ov])
    C = np.stack([scene["poses"][views[v][2]][1] for v in ov])
    f, cx, cy, k1, k2, k3 = np.asarray([scene["intrinsics"][views[v][1]] for v in ov]).T
    Xc = np.einsum("nij,nj->ni", R, scene["X"][ol] - C)
    p = Xc[:, :2] / Xc[:, 2:]
    r2 = (p * p).sum(1)
    d = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    px = f[:, None] * d[:, None] * p + np.c_[cx, cy]
    return float(np.sqrt(((px - ox) ** 2).sum(1).mean()))


def round_mantissa(a, bits):
    """Round float64 values to `bits` explicit mantissa bits (TF32: 10),
    to nearest even."""
    a = np.asarray(a, np.float64)
    m, e = np.frexp(a)
    return np.ldexp(np.round(m * 2.0 ** (bits + 1)) / 2.0 ** (bits + 1), e)


def rounded_scene(scene, bits):
    """The scene with every pose, intrinsic and point value rounded to
    `bits` mantissa bits: the answer as a lower precision holds it."""
    out = dict(scene)
    out["poses"] = {k: (round_mantissa(R, bits), round_mantissa(C, bits))
                    for k, (R, C) in scene["poses"].items()}
    out["intrinsics"] = {k: tuple(round_mantissa(np.asarray(v), bits))
                         for k, v in scene["intrinsics"].items()}
    out["X"] = round_mantissa(scene["X"], bits)
    return out


def ba_excess(scene, max_iterations=30):
    """(C - C*) / C* of the scene (see the module note); inf without
    observations."""
    import torch

    from benchmark.reference import bal_lm

    ov, ol, ox = scene["obs"]
    if len(ov) == 0:
        return float("inf")
    views = scene["views"]
    pose_ids = sorted(scene["poses"])
    cam_of_pose = {p: i for i, p in enumerate(pose_ids)}
    intr_of_pose = {}
    for v in ov:
        intr_of_pose[views[v][2]] = scene["intrinsics"][views[v][1]]
    d = torch.float64

    def T(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=d)

    R = T([scene["poses"][p][0] for p in pose_ids])
    C = T([scene["poses"][p][1] for p in pose_ids])
    t = -torch.einsum("nij,nj->ni", R, C)
    prm = np.asarray([intr_of_pose.get(p, (1.0, 0, 0, 0, 0, 0)) for p in pose_ids], np.float64)
    intr, pp, k3 = T(prm[:, [0, 3, 4]]), T(prm[:, 1:3]), T(prm[:, 5])
    cam = torch.as_tensor([cam_of_pose[views[v][2]] for v in ov])
    data = (cam, torch.as_tensor(ol), T(ox))
    c0 = bal_lm.robust_cost(R, t, intr, T(scene["X"]), *data, pp=pp, k3=k3)
    *_, c1, _ = bal_lm.solve(R, t, intr, T(scene["X"]), *data, max_iterations=max_iterations,
                             pp=pp, k3=k3, fix_intr=True)
    return (c0 - c1) / c1 if c1 > 0 else float("inf")


def swapped_poses(scene, a=0, b=None):
    """The scene with two views' poses exchanged: an answer filed under
    the wrong view."""
    ids = sorted(scene["poses"])
    b = ids[len(ids) // 2] if b is None else b
    out = dict(scene)
    out["poses"] = dict(scene["poses"])
    out["poses"][ids[a]], out["poses"][b] = scene["poses"][b], scene["poses"][ids[a]]
    return out


def shifted_matches(matches):
    """Every filtered match's second feature taken from the pair's previous
    match: an answer altered where it is produced."""
    return {k: np.c_[m[:, 0], np.roll(m[:, 1], 1)] for k, m in matches.items()}
