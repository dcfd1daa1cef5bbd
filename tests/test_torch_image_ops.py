"""Port parity for the image toolbox: openmvg_torch/ops/image_ops.py
against openmvg_tpu/ops/image_ops.py on the same numpy inputs, on the CPU.

Float64 inputs agree to 1e-12 (the same arithmetic, summed in another
order by F.conv2d and XLA's convolution); float32 inputs to 1e-6, where
the reference's float64 sample grids (x64) promote its result and the
port's stay float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmvg_tpu.models import cameras as jcm
from openmvg_tpu.ops import image_ops as jim
from openmvg_torch.ops import image_ops as tim


def _img(seed, shape=(2, 37, 45), dtype=np.float64):
    return np.random.default_rng(seed).uniform(size=shape).astype(dtype)


def _close(got, ref, dtype):
    tol = 1e-12 if dtype == np.float64 else 1e-6
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, np.float64), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["sobel_x", "sobel_y", "scharr_x", "scharr_y", "half_sample",
                                  "double_sample", "integral_image"])
def test_unary_ops(name, dtype):
    a = _img(1, dtype=dtype)
    _close(getattr(tim, name)(torch.as_tensor(a)), getattr(jim, name)(jnp.asarray(a)), dtype)


@pytest.mark.parametrize("sigma", [0.8, 1.6, 3.2])
def test_gaussian_filter(sigma):
    a = _img(2)
    _close(tim.gaussian_filter(torch.as_tensor(a), sigma),
           jim.gaussian_filter(jnp.asarray(a), sigma), np.float64)


def test_separable_convolution():
    a = _img(3, shape=(29, 31))
    kx, ky = [0.25, 0.5, 0.25], [-1.0, 0.0, 2.0, 0.5, -0.5]
    _close(tim.separable_convolution(torch.as_tensor(a), kx, ky),
           jim.separable_convolution(jnp.asarray(a), kx, ky), np.float64)


def test_box_sum():
    a = _img(4, shape=(20, 21))
    ii_t, ii_j = tim.integral_image(torch.as_tensor(a)), jim.integral_image(jnp.asarray(a))
    for box in [(3, 4, 10, 12), (0, 0, 20, 21), (0, 5, 1, 6), (7, 0, 8, 21)]:
        _close(tim.box_sum(ii_t, *box), jim.box_sum(ii_j, *box), np.float64)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_warp_homography(dtype):
    a = _img(5, dtype=dtype)
    th = np.deg2rad(12.0)
    H = np.array([[1.15 * np.cos(th), -1.15 * np.sin(th), 4.0],
                  [1.15 * np.sin(th), 1.15 * np.cos(th), -3.0], [1e-4, -2e-4, 1.0]])
    _close(tim.warp_homography(torch.as_tensor(a), H), jim.warp_homography(jnp.asarray(a), H),
           dtype)
    _close(tim.warp_homography(torch.as_tensor(a), H, out_shape=(30, 50)),
           jim.warp_homography(jnp.asarray(a), H, out_shape=(30, 50)), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.uint8])
def test_rgb_to_gray(dtype):
    rgb = (np.random.default_rng(6).uniform(size=(5, 7, 3)) * 255).astype(dtype)
    got = tim.rgb_to_gray(torch.as_tensor(rgb))
    ref = jim.rgb_to_gray(jnp.asarray(rgb))
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    _close(got, ref, np.float64 if dtype == np.float64 else np.float32)


@pytest.mark.parametrize("kind,disto", [(jcm.PINHOLE, ()), (jcm.PINHOLE_RADIAL_K3, (0.1, -0.05, 0.01)),
                                        (jcm.PINHOLE_BROWN, (0.05, 0.01, -0.01, 1e-3, -2e-3)),
                                        (jcm.PINHOLE_FISHEYE, (0.02, 0.01, 0.0, 0.0))])
def test_undistort_image(kind, disto):
    a = _img(7, shape=(40, 44))
    c = jcm.make_pinhole(44, 40, 50.0, kind=kind, disto=disto)
    _close(tim.undistort_image(torch.as_tensor(a), kind, torch.as_tensor(c.params[0]), 44.0, 40.0),
           jim.undistort_image(jnp.asarray(a), kind, jnp.asarray(c.params[0]), 44.0, 40.0),
           np.float64)
