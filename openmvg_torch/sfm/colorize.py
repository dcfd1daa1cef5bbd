"""Scene colorisation (counterpart: openmvg_tpu/sfm/colorize.py; openMVG
sfm/sfm_data_colorization.cpp ColorizeTracks): each valid landmark takes
the pixel at its first valid observation, each image read once."""

import os

import numpy as np

from openmvg_torch.io.image import read_image


def colorize(scene):
    """(L, 3) uint8 RGB colours of the valid landmarks (zeros elsewhere)."""
    colors = np.zeros((len(scene.X), 3), np.uint8)
    ok = scene.obs_valid & scene.X_valid[scene.obs_landmark]
    done = np.zeros(len(scene.X), bool)
    by_view = {}
    for idx in np.nonzero(ok)[0]:
        by_view.setdefault(int(scene.obs_view[idx]), []).append(idx)
    for v, idxs in by_view.items():
        path = os.path.join(scene.root_path, scene.view_filename[v])
        if not os.path.exists(path):
            continue
        img = read_image(path)
        h, w = img.shape[:2]
        for idx in idxs:
            l = int(scene.obs_landmark[idx])
            if done[l]:
                continue
            x, y = scene.obs_x[idx]
            colors[l] = img[int(np.clip(round(y), 0, h - 1)), int(np.clip(round(x), 0, w - 1))]
            done[l] = True
    return colors
