"""Image describer dispatch (counterpart: openmvg_tpu/sfm/describer.py).

Reference parity: features/image_describer.hpp Describe and the method /
preset enums of main_ComputeFeatures.cpp:77-86.  SIFT and SIFT_ANATOMY map
to ops/sift.py, one batch of same-shape images a call; AKAZE_FLOAT and
AKAZE_MLDB to ops/akaze.py, image by image (the preset does not apply), as
the reference's batch function runs them.
"""

import numpy as np
import torch

from openmvg_torch.ops import sift

PRESETS = {
    # SIFT_Anatomy_Image_Describer.hpp:88-107/140
    "NORMAL": dict(peak_threshold=0.04, first_octave=0),
    "HIGH": dict(peak_threshold=0.01, first_octave=0),
    "ULTRA": dict(peak_threshold=0.01, first_octave=-1),
}


def make_config(method="SIFT", preset="NORMAL", max_features=8192,
                image_shape=None):
    p = PRESETS.get(preset.upper(), PRESETS["NORMAL"])
    first_octave = p["first_octave"]
    n_oct = 4 - first_octave
    if image_shape is not None:
        # octave cap from the (possibly upsampled) base image, >= 32 px
        base = min(image_shape) * (2 if first_octave == -1 else 1)
        n_oct = max(1, min(6, int(np.log2(base / 16))))
    return sift.SiftConfig(peak_threshold=p["peak_threshold"],
                           n_octaves=n_oct, first_octave=first_octave,
                           max_per_octave=max(256, max_features // n_oct))


def _check_method(method):
    method = method.upper()
    if method not in ("SIFT", "SIFT_ANATOMY") and not method.startswith("AKAZE"):
        raise ValueError(f"unknown describer method {method}")
    return method


def describe_images_batch(gray_images, method="SIFT", preset="NORMAL",
                          max_features=8192, upright=False, device="cuda"):
    """List of same-shape (H, W) float [0, 1] images -> list of (feats
    (N, 4) [x y scale ori] float32, descs), on `device`: SIFT (N, 128)
    uint8 in one batch; AKAZE_FLOAT (N, 64) float32 and AKAZE_MLDB (N, 60)
    uint8 image by image."""
    method = _check_method(method)
    if method.startswith("AKAZE"):
        from openmvg_torch.ops import akaze

        return [akaze.extract_to_numpy(im, method=method, max_features=max_features,
                                       upright=upright, device=device)
                for im in gray_images]
    cfg = make_config(method, preset, max_features, gray_images[0].shape)
    imgs = torch.as_tensor(np.stack(gray_images).astype(np.float32),
                           device=device)
    fb = sift.extract_batch(imgs, cfg, upright=upright)
    return [sift.compact(sift.SiftFeatures(*[x[b] for x in fb]), max_features)
            for b in range(len(gray_images))]


def describe_image(gray_image, method="SIFT", preset="NORMAL",
                   max_features=8192, upright=False, device="cuda"):
    """(H, W) float [0, 1] -> (feats (N, 4), descs) as describe_images_batch."""
    return describe_images_batch([gray_image], method, preset, max_features,
                                 upright, device)[0]
