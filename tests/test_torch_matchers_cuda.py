"""The matching and filtering slice on the card against its plain versions:
guided matching's batched K1 route against the per-pair plain route, the
VLAD Lloyd sums through K2 against seg_sum_plain, and the cascade matcher
on the card against the CPU with ties forced.  Every test needs an NVIDIA
card and nvcc and skips without them.  On a machine with a card (which need
not have JAX; the repo's conftest imports it, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_matchers_cuda.py -q

Guided matching and the cascade are exact (u8 distances and Hamming
distances are integers); K2's float32 sums are held to 1e-5 (1 + S) of the
plain float64 sum, S the sum of magnitudes behind each output, as in
tests/test_torch_seg_sum_cuda.py.
"""

import numpy as np
import pytest
import torch

from openmvg_torch.ops import matching as tm
from openmvg_torch.ops import seg_sum as k2
from openmvg_torch.ops import two_nn as k1
from openmvg_torch.ops import vlad
from openmvg_torch.sfm import known_poses

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels K1 and K2 run only there")
    k1.build()
    k2.build()
    return torch.device("cuda")


def _views(seed, counts=(700, 520, 640, 300, 700)):
    """u8 descriptor lists with shared rows, duplicates and sub-pixel features."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(800, 128))
    descs, feats = [], []
    for n in counts:
        sel = rng.permutation(800)[:n]
        d = np.clip(base[sel] + rng.integers(-4, 5, (n, 128)), 0, 255).astype(np.uint8)
        d[-20:] = d[:20]                      # duplicated rows: L2 and Hamming ties
        descs.append(d)
        feats.append(np.c_[rng.uniform(0, 1000, (n, 2)), np.ones((n, 2))])
    return feats, descs


def test_guided_batch_on_card_equals_pair_by_pair_plain(dev):
    feats, descs = _views(0)
    pairs = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    rng = np.random.default_rng(1)
    Fs = rng.normal(size=(len(pairs), 3, 3))
    thr = rng.uniform(50.0, 300.0, len(pairs))
    k1.LAUNCHES = 0
    got = known_poses.guided_matching_batch(feats, descs, pairs, Fs, thr, device=dev)
    assert k1.LAUNCHES == 1                   # every pair in one launch
    for (i, j), F, t, g in zip(pairs, Fs, thr, got):
        want = known_poses.guided_matching_batch(feats, descs, [(i, j)], F[None], t,
                                                 device="cpu")[0]
        np.testing.assert_array_equal(g, want)
    assert sum(len(g) for g in got) > 200


@pytest.mark.parametrize("k", [8, 64])
def test_vlad_lloyd_sums_on_k2_equal_plain(dev, k):
    """SIFT-like rows around k separated centres (no assignment near a tie),
    the Lloyd sums through K2 in two 64-column launches of one plan."""
    rng = np.random.default_rng(k)
    c = rng.integers(20, 236, size=(k, 128))
    lab = rng.integers(0, k, 20000)
    X = np.clip(c[lab] + rng.normal(scale=8.0, size=(20000, 128)), 0, 255).astype(np.float32)
    X = torch.as_tensor(X, device=dev)
    first = [int(np.nonzero(lab == i)[0][0]) for i in range(k)]
    centers = X[torch.as_tensor(first, device=dev)]
    assign = vlad.nearest_center(X, centers)
    k2.LAUNCHES = 0
    got = vlad.cluster_sums(X, assign, k)
    assert k2.LAUNCHES == 2                   # two 64-column blocks, one plan
    X64, a64 = X.double().cpu(), assign.cpu()
    want = k2.seg_sum_plain(X64, a64, k)
    S = k2.seg_sum_plain(X64.abs(), a64, k)
    err = ((got.double().cpu() - want).abs() / (1.0 + S)).max()
    assert float(err) <= 1e-5
    assert torch.equal(got, vlad.cluster_sums(X, assign, k))   # bitwise repeatable
    c_dev, a_dev = vlad._lloyd(X, centers, n_iter=5)
    c_cpu, a_cpu = vlad._lloyd(X.cpu(), centers.cpu(), n_iter=5)
    assert torch.equal(a_dev.cpu(), a_cpu)
    np.testing.assert_allclose(c_dev.cpu().numpy(), c_cpu.numpy(), rtol=1e-5, atol=1e-4)


def test_cascade_on_card_equals_cpu_with_ties(dev):
    feats, descs = _views(2)
    pairs = [(0, 1), (1, 2), (0, 4), (3, 4), (2, 3)]
    proj = tm.make_hash_projections(0)
    mean = torch.as_tensor(descs[0].mean(0).astype(np.float32))
    got = tm.match_descriptor_lists(descs, pairs, 0.8, dev, method="cascade",
                                    proj=proj.to(dev), mean=mean.to(dev))
    want = tm.match_descriptor_lists(descs, pairs, 0.8, "cpu", method="cascade", proj=proj,
                                     mean=mean)
    assert sorted(got) == sorted(want)
    for p in want:
        np.testing.assert_array_equal(got[p], want[p])
    assert sum(len(m) for m in want.values()) > 500
