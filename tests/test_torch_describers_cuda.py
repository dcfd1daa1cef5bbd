"""The describers and the spherical path on the card against the port's
CPU runs: K1 at AKAZE_FLOAT's 64-d float32 against its plain version,
AKAZE (both descriptors), FAST and KLT, LIOP and DIPOLE, and cubify's
batched gather.  Every
test needs an NVIDIA card (K1 also nvcc) and skips without one.  On a
machine with a card (which need not have JAX; the repo's conftest imports
it, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_describers_cuda.py -q

Tolerances: K1 float32 within 1e-4 (1 + |d|) and idx1 equal away from
near-ties, as in chip_smoke.py; FAST corners equal; KLT within 1e-3 px;
AKAZE keypoints paired by position within 1e-3 px, MSURF within 1e-4,
MLDB at most 1 bit in 1,000 flipped, LIOP and DIPOLE within 1e-5 (the
CPU parity tests' tolerances); cube faces within 1e-3 on 0..255.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage
from scipy.spatial import cKDTree

from openmvg_torch.ops import akaze, dipole, fast, liop, spherical
from openmvg_torch.ops import two_nn as k1

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's card paths run only there")
    return torch.device("cuda")


def _textured(seed, shape=(256, 256)):
    rng = np.random.default_rng(seed)
    img = ndimage.gaussian_filter(rng.uniform(0, 1, shape), 2.0)
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


def test_k1_at_64d_float32(dev):
    k1.build()
    rng = np.random.default_rng(0)
    d = rng.normal(size=(5, 1500, 64)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[1, :200] = d[0, :200] + 1e-3 * rng.normal(size=(200, 64))     # near matches
    descs = torch.as_tensor(d, device=dev)
    counts = torch.tensor([1500, 1400, 1, 1000, 0], dtype=torch.int32, device=dev)
    pairs = torch.tensor([(i, j) for i in range(5) for j in range(5) if i != j],
                         dtype=torch.int32, device=dev)
    before = k1.LAUNCHES
    got = k1.two_nn_batch(descs, counts, pairs)
    assert k1.LAUNCHES == before + 1
    ref = k1.two_nn_batch_plain(descs, counts, pairs)
    for x, y in zip(got[:2], ref[:2]):
        assert ((x - y).abs() <= 1e-4 * (1 + y.abs())).all()
    near_tie = (ref[1] - ref[0]) <= 2e-4 * (1 + ref[0])
    assert not ((got[2] != ref[2]) & ~near_tie).any()


@pytest.mark.parametrize("descriptor", ["MSURF", "MLDB"])
def test_akaze_card_against_cpu(dev, descriptor):
    img = _textured(1)
    cfg = akaze.AkazeConfig(descriptor=descriptor)
    fc, dc = akaze.extract_to_numpy(img, cfg=cfg, device="cpu")
    fg, dg = akaze.extract_to_numpy(img, cfg=cfg, device=dev)
    assert fg.shape == fc.shape and dg.shape == dc.shape and len(fc) > 100
    dist, idx = cKDTree(np.c_[fc[:, :2], 1e3 * fc[:, 2]]).query(np.c_[fg[:, :2], 1e3 * fg[:, 2]])
    assert dist.max() < 1e-2 and len(set(idx.tolist())) == len(idx)
    fc, dc = fc[idx], dc[idx]
    np.testing.assert_allclose(fg[:, :3], fc[:, :3], atol=1e-3)
    same_ori = np.abs(fg[:, 3] - fc[:, 3]) < 1e-5
    assert same_ori.mean() > 0.99
    if descriptor == "MLDB":
        assert np.unpackbits(dg[same_ori] ^ dc[same_ori]).sum() <= 1e-3 * 360 * same_ori.sum()
    else:
        np.testing.assert_allclose(dg[same_ori], dc[same_ori], atol=1e-4)


def test_fast_and_klt_card_against_cpu(dev):
    img0 = np.round(_textured(2) * 255).astype(np.float32) / 255
    img1 = np.roll(img0, (3, -5), axis=(0, 1))
    out = {}
    for d in ("cpu", dev):
        a, b = torch.as_tensor(img0, device=d), torch.as_tensor(img1, device=d)
        xy, score, ok = fast.fast_detect(a, threshold=0.05, max_corners=512)
        pts = xy[ok]
        out[str(d)] = [t.cpu().numpy() for t in (xy, score, ok, *fast.klt_track(a, b, pts))]
    c, g = out["cpu"], out[str(dev)]
    np.testing.assert_array_equal(g[0], c[0])
    np.testing.assert_array_equal(g[2], c[2])
    np.testing.assert_allclose(g[1], c[1], atol=1e-6)
    np.testing.assert_array_equal(g[4], c[4])
    np.testing.assert_allclose(g[3][c[4]], c[3][c[4]], atol=1e-3)


def test_liop_dipole_card_against_cpu(dev):
    """Their grays are ordered and counted alike on both devices (the ring
    tables come from the host): a flipped order would move a LIOP entry by
    about 1e-2."""
    img = _textured(4, (512, 512)) * 255
    rng = np.random.default_rng(5)
    xy = np.c_[rng.uniform(0, 511, 2000), rng.uniform(0, 511, 2000)]
    sc, ori = rng.uniform(0.8, 4.0, 2000), rng.uniform(-np.pi, np.pi, 2000)
    for fn, args in ((liop.liop_describe, (xy, sc)), (dipole.dipole_describe, (xy, sc, ori))):
        c = fn(torch.as_tensor(img), *args).numpy()
        g = fn(torch.as_tensor(img, device=dev), *args).cpu().numpy()
        np.testing.assert_allclose(g, c, atol=1e-5)


def test_cubify_gather_card_against_cpu(dev):
    rng = np.random.default_rng(3)
    pano = ndimage.gaussian_filter(rng.uniform(0, 255, (512, 1024, 3)), (3, 3, 0)).astype(np.uint8)
    fc, rc, _ = spherical.spherical_to_cubic(torch.as_tensor(pano))
    fg, rg, _ = spherical.spherical_to_cubic(torch.as_tensor(pano, device=dev))
    np.testing.assert_array_equal(rg, rc)
    assert fg.shape == (6, 256, 256, 3)
    np.testing.assert_allclose(fg.cpu().numpy(), fc.numpy(), atol=1e-3)
