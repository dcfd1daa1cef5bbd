"""The STELLAR engine on the card, where its float32 BAs take the fused
S-matvec (K3) by default: on the 8-view ring it launches K2 and K3, poses
every view, and its camera centres agree with the same run on the CPU
(where both kernels take their plain versions) within 1e-4 after 7-DoF
alignment, on a ring of radius 2.  The alignment takes out the gauge
(the bundle adjustment leaves the scale free, and the two devices' float32
sums move it by about 0.1%).  Needs an NVIDIA card and nvcc and skips
without them.  On a machine with a card (which need not have JAX; the
repo's conftest imports it, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_stellar_cuda.py -q

The ring is built here with numpy, as the reference's
utils/synthetic.py::ring_scene builds it, so the test imports nothing of
the JAX package.
"""

import numpy as np
import pytest
import torch

from openmvg_torch.geometry.similarity import find_rts
from openmvg_torch.models import cameras as cm
from openmvg_torch.ops import seg_sum as k2
from openmvg_torch.ops import smatvec as k3
from openmvg_torch.sfm.pipeline_stellar import StellarConfig, stellar_sfm
from openmvg_torch.sfm.scene import Scene, rmse

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels K2 and K3 run only there")
    return "cuda"


def _look_at(center):
    z = -center / np.linalg.norm(center)
    x = np.cross([0.0, 1e-6, 1.0], z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def ring_data(n_views=8, n_points=150, noise_px=0.4, seed=2):
    """An unposed scene of n_views pinhole cameras (focal 1000, 1000^2) on
    a ring of radius 2 around a unit point cloud, features = projections
    plus noise, and matches between each view and its next three on the
    points both see; and the true camera centres."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-0.5, 0.5, (n_points, 3))
    th = 2 * np.pi * np.arange(n_views) / n_views
    C = np.stack([2 * np.cos(th), 0.2 * np.sin(2 * th), 2 * np.sin(th)], 1)
    R = np.stack([_look_at(c) for c in C])
    Xc = np.einsum("vij,vpj->vpi", R, X[None] - C[:, None])
    x = 1000.0 * Xc[..., :2] / Xc[..., 2:] + 500.0
    vis = (Xc[..., 2] > 0) & (x >= 0).all(-1) & (x < 1000).all(-1)
    feats = [x[v] + rng.normal(scale=noise_px, size=x[v].shape) for v in range(n_views)]
    matches = {}
    for i in range(n_views):
        for j in range(i + 1, min(i + 4, n_views)):
            m = np.nonzero(vis[i] & vis[j])[0]
            matches[(i, j)] = np.stack([m, m], 1)
    sc = Scene(view_filename=[f"v{i}.jpg" for i in range(n_views)],
               view_intrinsic=np.zeros(n_views, np.int32),
               view_pose=np.arange(n_views, dtype=np.int32),
               view_wh=np.full((n_views, 2), 1000, np.int32),
               cameras=cm.make_pinhole(1000, 1000, 1000.0),
               pose_valid=np.zeros(n_views, bool), pose_R=np.tile(np.eye(3), (n_views, 1, 1)),
               pose_C=np.zeros((n_views, 3)))
    return sc, feats, matches, C


def test_stellar_on_the_card_launches_k2_and_k3(dev):
    cfg = StellarConfig(ransac_samples=512, ba_iterations=15)
    scenes = {}
    for device in ("cpu", dev):
        sc, feats, matches, C = ring_data()
        k2.LAUNCHES = k3.LAUNCHES = 0
        stats = {}
        stellar_sfm(sc, feats, matches, cfg, seed=0, device=device, stats=stats)
        torch.cuda.synchronize()
        if device == dev:
            assert k2.LAUNCHES > 0 and k3.LAUNCHES > 0
        else:
            assert k2.LAUNCHES == 0 and k3.LAUNCHES == 0
        assert int(sc.pose_valid.sum()) == 8 and stats["pods"] == 8
        assert rmse(sc) < 0.7
        scenes[device] = sc
    cpu, gpu = scenes["cpu"].pose_C, scenes[dev].pose_C
    sim = find_rts(torch.as_tensor(gpu)[None], torch.as_tensor(cpu)[None])
    aligned = sim.apply(torch.as_tensor(gpu)[None])[0].numpy()
    np.testing.assert_allclose(aligned, cpu, atol=1e-4)
