"""General image processing ops, the image layer's toolbox (counterpart:
openmvg_tpu/ops/image_ops.py).

Reference parity: openMVG/image/ — image_convolution.hpp:178-297 separable
convolution, image_filtering.hpp:279 Gaussian filter, :81-276 Sobel and
Scharr derivatives, image_resampling.hpp:27 half-sampling and 2x
upsampling, integral image, generic warping (sampler), RGB to gray
(image_converter.hpp), Camera_undistort_image.hpp.

Every op takes (..., H, W) tensors and runs on their device: convolutions
are F.conv2d over a replicate-padded 4-D view, resampling is one batched
bilinear gather over every leading index.
"""

import numpy as np
import torch
import torch.nn.functional as F

from openmvg_torch.models import cameras as cm
from openmvg_torch.ops.sift import _blur as gaussian_filter  # noqa: F401


def _conv2(img, kernel):
    """'Same' correlation with edge padding; img (..., H, W), kernel (kh, kw)."""
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    x = F.pad(img.reshape((-1, 1) + img.shape[-2:]), (pw, pw, ph, ph), mode="replicate")
    k = torch.as_tensor(np.asarray(kernel, np.float64), device=img.device).to(img.dtype)
    return F.conv2d(x, k.view(1, 1, kh, kw)).reshape(img.shape)


def separable_convolution(img, kx, ky):
    """Rows with kx, then columns with ky (image_convolution.hpp)."""
    out = _conv2(img, np.asarray(kx, np.float64).reshape(1, -1))
    return _conv2(out, np.asarray(ky, np.float64).reshape(-1, 1))


def sobel_x(img):
    return _conv2(img, np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]) / 8.0)


def sobel_y(img):
    return _conv2(img, np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]]) / 8.0)


def scharr_x(img):
    return _conv2(img, np.array([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]]) / 32.0)


def scharr_y(img):
    return _conv2(img, np.array([[-3, -10, -3], [0, 0, 0], [3, 10, 3]]) / 32.0)


def half_sample(img):
    """2x decimation after a light anti-alias blur (ImageHalfSample)."""
    return gaussian_filter(img, 0.8)[..., ::2, ::2]


def _sample_all(img, ys, xs):
    """Bilinear samples of every (H, W) image of img (..., H, W) at the same
    coordinates ys, xs (any shape S) -> (..., *S): ops/sift.py::_bilinear
    with one gather for all leading indices."""
    H, W = img.shape[-2:]
    flat = img.reshape((-1, H, W))
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, H - 2)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, W - 2)
    fy = torch.clamp(ys - y0, 0.0, 1.0)
    fx = torch.clamp(xs - x0, 0.0, 1.0)
    out = (flat[:, y0, x0] * (1 - fy) * (1 - fx) + flat[:, y0, x0 + 1] * (1 - fy) * fx
           + flat[:, y0 + 1, x0] * fy * (1 - fx) + flat[:, y0 + 1, x0 + 1] * fy * fx)
    return out.reshape(img.shape[:-2] + ys.shape)


def double_sample(img):
    """2x bilinear upsampling (ImageDoubleSize)."""
    H, W = img.shape[-2:]
    dt = img.dtype
    ys = (torch.arange(2 * H, device=img.device, dtype=dt) + 0.5) / 2.0 - 0.5
    xs = (torch.arange(2 * W, device=img.device, dtype=dt) + 0.5) / 2.0 - 0.5
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    return _sample_all(img, Y, X)


def integral_image(img):
    """Summed-area table (image_integral.hpp)."""
    return torch.cumsum(torch.cumsum(img, dim=-1), dim=-2)


def box_sum(ii, y0, x0, y1, x1):
    """Rectangle sums from an integral image (exclusive upper bounds)."""
    def g(y, x):
        y = torch.as_tensor(y, device=ii.device)
        x = torch.as_tensor(x, device=ii.device)
        valid = (y >= 0) & (x >= 0)
        yy = torch.clamp(y, 0, ii.shape[-2] - 1)
        xx = torch.clamp(x, 0, ii.shape[-1] - 1)
        return torch.where(valid, ii[..., yy, xx], torch.zeros((), dtype=ii.dtype,
                                                               device=ii.device))

    return g(y1 - 1, x1 - 1) - g(y0 - 1, x1 - 1) - g(y1 - 1, x0 - 1) + g(y0 - 1, x0 - 1)


def warp_homography(img, H, out_shape=None):
    """Inverse warp by a 3x3 homography (generic sampler, image_warping):
    float64 source coordinates, 0 outside the source image."""
    Hh, Ww = img.shape[-2:] if out_shape is None else out_shape
    dev = img.device
    ys, xs = torch.meshgrid(torch.arange(Hh, dtype=torch.float64, device=dev),
                            torch.arange(Ww, dtype=torch.float64, device=dev), indexing="ij")
    Hinv = torch.linalg.inv(torch.as_tensor(np.asarray(H, np.float64), device=dev))
    sx = Hinv[0, 0] * xs + Hinv[0, 1] * ys + Hinv[0, 2]
    sy = Hinv[1, 0] * xs + Hinv[1, 1] * ys + Hinv[1, 2]
    sw = Hinv[2, 0] * xs + Hinv[2, 1] * ys + Hinv[2, 2]
    sx = sx / sw
    sy = sy / sw
    v = _sample_all(img, sy, sx)
    inside = ((sx >= 0) & (sx <= img.shape[-1] - 1) & (sy >= 0) & (sy <= img.shape[-2] - 1))
    return torch.where(inside, v, torch.zeros((), dtype=v.dtype, device=dev))


def rgb_to_gray(rgb):
    """Rec.601 weights (image_converter.hpp Rgb2Gray); rgb (..., 3)."""
    dt = rgb.dtype if rgb.is_floating_point() else torch.float32
    w = torch.tensor([0.299, 0.587, 0.114], dtype=dt, device=rgb.device)
    return torch.tensordot(rgb.to(dt), w, dims=([-1], [0]))


def undistort_image(img, kind, params, width, height):
    """Resample to the undistorted frame (Camera_undistort_image.hpp):
    out(p) = in(add_disto(p)) through cam2ima / ima2cam, in float64."""
    H, W = img.shape[-2:]
    dev = img.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=dev),
                            torch.arange(W, dtype=torch.float64, device=dev), indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
    k = torch.as_tensor(kind, dtype=torch.int32, device=dev)
    p = torch.as_tensor(params, dtype=torch.float64, device=dev)
    w = torch.as_tensor(float(width), dtype=torch.float64, device=dev)
    h = torch.as_tensor(float(height), dtype=torch.float64, device=dev)
    cam = cm.ima2cam(k, p, w, h, pix)
    src = cm.cam2ima(k, p, w, h, cm.add_disto(k, p, cam))
    return _sample_all(img, src[:, 1], src[:, 0]).reshape(img.shape[:-2] + (H, W))
