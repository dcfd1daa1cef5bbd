"""Ground-truth cameras in the Strecha format (counterpart:
openmvg_tpu/io/gt_loaders.py, load_strecha_gt and its writer;
io_readGTStrecha.hpp): one "<image>.camera" text file per view with
K (9), three zeros, R^T (9), C (3) and the image size (2)."""

import glob
import os

import numpy as np

from openmvg_torch.models import cameras as cm
from openmvg_torch.sfm.scene import Scene


def write_strecha_camera(path, K, R, C, wh):
    """One `<image>.camera` file: K (9), three zeros, R^T (9), C (3), w h."""
    vals = list(np.asarray(K).reshape(-1)) + [0.0, 0.0, 0.0] \
        + list(np.asarray(R).T.reshape(-1)) + list(C) + [wh[0], wh[1]]
    with open(path, "w") as f:
        f.write(" ".join(str(v) for v in vals))


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
    n = len(names)
    scene = Scene()
    scene.view_filename = names
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
    scene.pose_R = np.asarray(Rs).reshape(n, 3, 3)
    scene.pose_C = np.asarray(Cs).reshape(n, 3)
    return scene
