"""Ground-truth dataset importers -> Scene (counterpart:
openmvg_tpu/io/gt_loaders.py; software/SfM/import/io_readGT*.hpp):
Strecha (one "<image>.camera" text file per view with K (9), three zeros,
R^T (9), C (3) and the image size (2)), and Middlebury, ETH3D, KITTI, DTU,
BlendedMVS and Multiface.  Host numpy; every view a PINHOLE intrinsic of
its own.
"""

import glob
import os

import numpy as np
import torch

from openmvg_torch.geometry.so3 import quat_to_rot
from openmvg_torch.models import cameras as cm
from openmvg_torch.sfm.scene import Scene


def write_strecha_camera(path, K, R, C, wh):
    """One `<image>.camera` file: K (9), three zeros, R^T (9), C (3), w h."""
    vals = list(np.asarray(K).reshape(-1)) + [0.0, 0.0, 0.0] \
        + list(np.asarray(R).T.reshape(-1)) + list(C) + [wh[0], wh[1]]
    with open(path, "w") as f:
        f.write(" ".join(str(v) for v in vals))


def _scene_from_krc(names, Ks, Rs, Cs, whs):
    n = len(names)
    scene = Scene()
    scene.view_filename = list(names)
    scene.view_intrinsic = np.arange(n, dtype=np.int32)
    scene.view_pose = np.arange(n, dtype=np.int32)
    scene.view_wh = np.asarray(whs, np.int32).reshape(n, 2)
    params = np.zeros((n, cm.MAX_PARAMS))
    for i, K in enumerate(Ks):
        params[i, 0:3] = [K[0, 0], K[0, 2], K[1, 2]]
    scene.cameras = cm.Cameras(kind=np.full(n, cm.PINHOLE, np.int32),
                               width=scene.view_wh[:, 0].astype(float),
                               height=scene.view_wh[:, 1].astype(float), params=params)
    scene.pose_valid = np.ones(n, bool)
    scene.pose_R = np.asarray(Rs, np.float64).reshape(n, 3, 3)
    scene.pose_C = np.asarray(Cs, np.float64).reshape(n, 3)
    return scene


def load_strecha_gt(gt_dir):
    """Every *.camera file of gt_dir (sorted) -> a Scene of PINHOLE views
    named by the image file (world->camera R is the file's R transposed)."""
    names, Ks, Rs, Cs, whs = [], [], [], [], []
    for f in sorted(glob.glob(os.path.join(gt_dir, "*.camera"))):
        with open(f) as fh:
            vals = np.array(fh.read().split(), float)
        if len(vals) not in (26, 27):
            continue
        names.append(os.path.basename(f)[:-len(".camera")])
        Ks.append(vals[0:9].reshape(3, 3))
        Rs.append(vals[12:21].reshape(3, 3).T)
        Cs.append(vals[21:24])
        whs.append(vals[24:26].astype(int))
    return _scene_from_krc(names, Ks, Rs, Cs, whs)


def load_middlebury_gt(filename, default_wh=(640, 480)):
    """Middlebury GT: one file, first line = image count, then per line
    'name K(9) R(9) t(3)' (io_readGTMiddleBury.hpp; t is world->cam
    translation)."""
    tok = open(filename).read().split()
    pos = 0
    count = int(tok[pos]); pos += 1
    names, Ks, Rs, Cs, whs = [], [], [], [], []
    for _ in range(count):
        name = tok[pos]; pos += 1
        vals = np.array(tok[pos:pos + 21], float); pos += 21
        K = vals[0:9].reshape(3, 3)
        R = vals[9:18].reshape(3, 3)
        t = vals[18:21]
        names.append(name)
        Ks.append(K)
        Rs.append(R)
        Cs.append(-R.T @ t)
        whs.append(default_wh)
    return _scene_from_krc(names, Ks, Rs, Cs, whs)


def load_eth3d_gt(gt_dir):
    """ETH3D GT: COLMAP-style cameras.txt (id model w h params) +
    images.txt (id qw qx qy qz tx ty tz cam_id name) (io_readGTETH3D.hpp)."""
    cams = {}
    for line in open(os.path.join(gt_dir, "cameras.txt")):
        if line.startswith("#") or not line.strip():
            continue
        p = line.split()
        cid, model, w, h = int(p[0]), p[1], int(p[2]), int(p[3])
        params = [float(x) for x in p[4:]]
        if model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            K = np.array([[params[0], 0, params[1]],
                          [0, params[0], params[2]], [0, 0, 1.0]])
        else:  # PINHOLE / others: fx fy cx cy
            K = np.array([[params[0], 0, params[2]],
                          [0, params[1], params[3]], [0, 0, 1.0]])
        cams[cid] = (K, (w, h))
    names, Ks, Rs, Cs, whs = [], [], [], [], []
    lines = [l for l in open(os.path.join(gt_dir, "images.txt"))
             if not l.startswith("#") and l.strip()]
    # images.txt alternates pose line / points2D line
    for line in lines[0::2] if len(lines) > 1 and len(lines[1].split()) % 3 == 0 \
            else lines:
        p = line.split()
        if len(p) < 10:
            continue
        qw, qx, qy, qz = map(float, p[1:5])
        t = np.array([float(x) for x in p[5:8]])
        cid = int(p[8])
        name = p[9]
        R = quat_to_rot(torch.tensor([qw, qx, qy, qz], dtype=torch.float64)).numpy()
        K, wh = cams[cid]
        names.append(name)
        Ks.append(K)
        Rs.append(R)
        Cs.append(-R.T @ t)
        whs.append(wh)
    return _scene_from_krc(names, Ks, Rs, Cs, whs)


def load_kitti_gt(gt_dir, calib_file=None, default_wh=(1226, 370)):
    """Kitti odometry GT: poses file with per-line 3x4 [R|C']... the
    reference reads 12 values as cam->world [R|C] (io_readGTKitti.hpp) and
    a calib.txt with P0..P3 projection matrices."""
    pose_files = sorted(glob.glob(os.path.join(gt_dir, "*.txt")))
    if calib_file is None:
        cand = [f for f in pose_files if "calib" in os.path.basename(f)]
        calib_file = cand[0] if cand else None
        pose_files = [f for f in pose_files if f != calib_file]
    K = np.array([[718.856, 0, 607.19], [0, 718.856, 185.216], [0, 0, 1.0]])
    if calib_file:
        for line in open(calib_file):
            if line.startswith("P0"):
                vals = np.array(line.split()[1:13], float).reshape(3, 4)
                K = vals[:, :3]
                break
    names, Ks, Rs, Cs, whs = [], [], [], [], []
    if pose_files:
        for i, line in enumerate(open(pose_files[0])):
            vals = np.array(line.split(), float)
            if len(vals) != 12:
                continue
            M = vals.reshape(3, 4)  # cam->world [R | C]
            R_cw = M[:, :3]
            C = M[:, 3]
            names.append(f"{i:06d}.png")
            Ks.append(K)
            Rs.append(R_cw.T)
            Cs.append(C)
            whs.append(default_wh)
    return _scene_from_krc(names, Ks, Rs, Cs, whs)


def load_dtu_gt(gt_dir, image_dir=None, default_wh=(1600, 1200)):
    """DTU MVS GT (io_readGTDTUMVS.hpp): per-view text file holding a 3x4
    projective matrix P; file name carries a 3-digit index at chars [4:7]
    that matches the image name chars [5:8]."""
    from openmvg_torch.ops.resection import krt_from_P

    files = sorted(f for f in os.listdir(gt_dir)
                   if os.path.isfile(os.path.join(gt_dir, f)))
    image_files = (sorted(os.listdir(image_dir))
                   if image_dir and os.path.isdir(image_dir) else [])
    names, Ks, Rs, Cs, whs = [], [], [], [], []
    for fn in files:
        vals = np.array(open(os.path.join(gt_dir, fn)).read().split(), float)
        if len(vals) != 12:
            continue
        P = vals.reshape(3, 4)
        K, R, t = (a.numpy() for a in krt_from_P(torch.as_tensor(P)))
        K = K / K[2, 2]
        index = os.path.splitext(fn)[0][4:7]
        name = next((im for im in image_files if im[5:8] == index), None)
        names.append(name if name is not None else f"image{index}.png")
        Ks.append(K)
        Rs.append(R)
        Cs.append(-R.T @ t)
        whs.append(default_wh)
    return _scene_from_krc(names, Ks, Rs, Cs, whs)


def load_blendedmvs_gt(gt_dir, default_wh=(768, 576)):
    """BlendedMVS GT (io_readGTBlendedMVS.hpp): per-view `*_cam.txt` with an
    'extrinsic' 4x4 [R|t] block then an 'intrinsic' 3x3 K block; the image is
    `<first 8 chars>.jpg`."""
    files = sorted(glob.glob(os.path.join(gt_dir, "*_cam.txt")))
    names, Ks, Rs, Cs, whs = [], [], [], [], []
    for fn in files:
        lines = open(fn).read().splitlines()
        try:
            ei = lines.index("extrinsic")
            vals = np.array(" ".join(lines[ei + 1:ei + 5]).split()[:16], float)
            ki = lines.index("intrinsic")
            kv = np.array(" ".join(lines[ki + 1:ki + 4]).split()[:9], float)
        except ValueError:
            continue
        E = vals.reshape(4, 4)
        R, t = E[:3, :3], E[:3, 3]
        names.append(os.path.basename(fn)[:8] + ".jpg")
        Ks.append(kv.reshape(3, 3))
        Rs.append(R)
        Cs.append(-R.T @ t)
        whs.append(default_wh)
    return _scene_from_krc(names, Ks, Rs, Cs, whs)


def load_multiface_gt(gt_dir, image_names=None, default_wh=(1334, 2048)):
    """Multiface GT (io_readGTMultiface.hpp): one `KRT` file with 9-line
    records: name, K rows (3), a pad line, then [R|t] rows (3), blank."""
    path = os.path.join(gt_dir, "KRT")
    lines = open(path).read().splitlines()
    names, Ks, Rs, Cs, whs = [], [], [], [], []
    for base in range(0, len(lines) - 7, 9):
        rec = lines[base:base + 9]
        name = rec[0].strip()
        if not name:
            break
        K = np.array(" ".join(rec[1:4]).split(), float)[:9].reshape(3, 3)
        Rt = np.array(" ".join(rec[5:8]).split(), float)[:12].reshape(3, 4)
        R, t = Rt[:, :3], Rt[:, 3]
        names.append(name + ".png")
        Ks.append(K)
        Rs.append(R)
        Cs.append(-R.T @ t)
        whs.append(default_wh)
    scene = _scene_from_krc(names, Ks, Rs, Cs, whs)
    if image_names is not None:   # keep only views with an existing image
        keep = [i for i, n in enumerate(scene.view_filename) if n in image_names]
        scene.view_filename = [scene.view_filename[i] for i in keep]
        scene.view_intrinsic = scene.view_intrinsic[keep]
        scene.view_pose = scene.view_pose[keep]
        scene.view_wh = scene.view_wh[keep]
    return scene
