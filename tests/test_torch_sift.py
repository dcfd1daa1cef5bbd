"""Port parity for SIFT: openmvg_tpu.ops.sift against openmvg_torch.ops.sift
on the blob images of tests/test_sift.py and on a 128^2 textured-sphere view.

Bounds and why: both run float32 on the CPU; the blurs, gathers and
histogram sums add in different orders (XLA vs PyTorch), and under x64 the
reference builds its sample grids in float64.  Refined positions then
differ by ~1e-4 px, so a keypoint must have a port twin within 1e-2 px,
1e-3 relative scale and 1e-2 rad orientation for at least 98% of the
reference's keypoints (a near-threshold candidate may flip either way),
and twins' uint8 descriptors may differ by at most 2 per entry (a bin sum
that lands within rounding of an integer step after the x512 scaling).
"""

import numpy as np
import pytest

from openmvg_tpu.io.image import read_image
from openmvg_tpu.ops import sift as jsift
from openmvg_tpu.sfm import describer as jdescriber
from openmvg_tpu.utils.synthetic import render_textured_sphere_dataset
from openmvg_torch.ops import sift as tsift
from openmvg_torch.sfm import describer as tdescriber

from test_sift import blob_image

CFG_J = jsift.SiftConfig(n_octaves=3, max_per_octave=256)
CFG_T = tsift.SiftConfig(n_octaves=3, max_per_octave=256)


def _blob_inputs():
    rng = np.random.default_rng(1)
    blobs = [(float(rng.uniform(30, 98)), float(rng.uniform(30, 98)),
              float(rng.uniform(3, 7))) for _ in range(6)]
    base = blob_image(blobs=[(40, 60, 4.0), (80, 40, 5.0), (70, 90, 3.5)],
                      noise=0.01, seed=5)
    return {
        # noise breaks the 4-fold symmetry of a lone blob, whose equal
        # orientation peaks would otherwise be a rounding-level tie
        "two_blobs": blob_image(blobs=[(40.0, 50.0, 4.0), (90.0, 80.0, 8.0)],
                                noise=0.01, seed=7),
        "six_blobs_noise": blob_image(blobs=blobs, noise=0.01, seed=2),
        "rot90": np.rot90(base).copy(),
    }


def _check_twins(fj, dj, ft, dt, min_share=0.98):
    assert len(fj) > 0
    assert abs(len(ft) - len(fj)) <= max(1, 0.02 * len(fj)), (len(ft), len(fj))
    found = 0
    worst = 0
    for k in range(len(fj)):
        dxy = np.abs(ft[:, :2] - fj[k, :2]).max(axis=1)
        dsc = np.abs(ft[:, 2] - fj[k, 2]) / fj[k, 2]
        dth = np.abs(np.angle(np.exp(1j * (ft[:, 3] - fj[k, 3]))))
        cand = np.nonzero((dxy < 1e-2) & (dsc < 1e-3) & (dth < 1e-2))[0]
        if len(cand):
            found += 1
            t = cand[np.argmin(dth[cand])]
            worst = max(worst, int(np.abs(dt[t].astype(int) - dj[k].astype(int)).max()))
    assert found >= min_share * len(fj), (found, len(fj))
    assert worst <= 2, worst


@pytest.mark.parametrize("name", ["two_blobs", "six_blobs_noise", "rot90"])
def test_sift_blobs_match_reference(name):
    img = _blob_inputs()[name]
    fj, dj = jsift.extract_to_numpy(img, CFG_J)
    ft, dt = tsift.extract_to_numpy(img, CFG_T, device="cpu")
    assert ft.dtype == np.float32 and dt.dtype == np.uint8
    _check_twins(fj, dj, ft, dt)


@pytest.fixture(scope="module")
def sphere_view(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sphere"))
    imgdir, _, _, _, _ = render_textured_sphere_dataset(d, n_views=1, size=128, seed=1)
    return read_image(f"{imgdir}/img_00.png", grayscale=True)


def test_sift_textured_sphere_matches_reference(sphere_view):
    fj, dj = jsift.extract_to_numpy(sphere_view, CFG_J)
    ft, dt = tsift.extract_to_numpy(sphere_view, CFG_T, device="cpu")
    assert len(fj) > 20
    _check_twins(fj, dj, ft, dt)


def test_describer_batch_matches_reference(sphere_view):
    """describe_images_batch with the HIGH preset (make_config path), a
    batch of two images (the view and its mirror)."""
    imgs = [sphere_view, np.ascontiguousarray(sphere_view[:, ::-1])]
    ref = jdescriber.describe_images_batch(imgs, "SIFT", "HIGH")
    got = tdescriber.describe_images_batch(imgs, "SIFT", "HIGH", device="cpu")
    for (fj, dj), (ft, dt) in zip(ref, got):
        _check_twins(fj, dj, ft, dt)


def test_sift_upright_and_ultra_shapes():
    """The upright (-u) and ULTRA (first_octave -1) branches agree too."""
    img = _blob_inputs()["six_blobs_noise"]
    for kw_j, kw_t, up in ((CFG_J, CFG_T, True),
                           (CFG_J._replace(first_octave=-1),
                            CFG_T._replace(first_octave=-1), False)):
        fj, dj = jsift.extract_to_numpy(img, kw_j, upright=up)
        ft, dt = tsift.extract_to_numpy(img, kw_t, upright=up, device="cpu")
        _check_twins(fj, dj, ft, dt)


def test_akaze_raises_until_ported():
    """AKAZE is ported (ops/akaze.py, parity in tests/test_torch_akaze.py):
    the describer takes it, a blank image gives no features of its widths,
    and only a name the reference does not know raises."""
    for method, dim, dt in (("AKAZE_FLOAT", 64, np.float32), ("AKAZE_MLDB", 60, np.uint8)):
        feats, descs = tdescriber.describe_image(np.zeros((32, 32), np.float32), method,
                                                 device="cpu")
        assert feats.shape == (0, 4) and descs.shape == (0, dim) and descs.dtype == dt
    with pytest.raises(ValueError, match="ORB"):
        tdescriber.describe_image(np.zeros((32, 32), np.float32), "ORB", device="cpu")
