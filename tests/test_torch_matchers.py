"""Port parity for the other matchers: cascade hashing, the host kd-tree
and brute-force Hamming, openmvg_torch against openmvg_tpu on the same
numpy inputs, on the CPU.

The cascade is exact on uint8 descriptors once the reference's hyperplanes
and mean are carried across as float32 tensors: the Hamming
distances are integers, the candidate list breaks ties to the lowest
column (the reference's approx_min_k made exact, see the test), and the
re-rank sums are integers below 2^24; idx_b, mask and dist are equal.  The
kd-tree and Hamming matchers are equal too.  With its own hyperplanes the port's
cascade is held to the reference test's recall against brute force.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmvg_tpu.ops import matching as jm
from openmvg_torch.ops import matching as tm


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs on several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tied_u8(seed, n=90, m=120):
    """u8 descriptors with forced ties: rows of b repeated exactly (equal
    Hamming and L2), near copies of a's rows, and low-entropy rows whose
    codes collide."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=(n, 128)).astype(np.uint8)
    b = rng.integers(0, 256, size=(m, 128)).astype(np.uint8)
    b[10:40] = np.clip(a[5:35].astype(int) + rng.integers(-3, 4, (30, 128)), 0, 255)
    b[40:50] = b[10:20]                      # exact duplicates: L2 ties
    b[50:70] = rng.integers(0, 2, (20, 128)) * 255
    a[60:80] = rng.integers(0, 2, (20, 128)) * 255
    return a, b


def _exact_min_k(x, k, recall_target=None):
    """jax.lax.approx_min_k made exact: top_k, ties to the lower index."""
    del recall_target
    v, i = jax.lax.top_k(-x, k)
    return -v, i


@pytest.mark.parametrize("seed", [0, 1])
def test_cascade_equals_reference_with_its_planes(seed, monkeypatch):
    """The reference's approx_min_k orders tied candidates as XLA's unstable
    sort leaves them (on the CPU too, for rows of more than a few columns),
    so the reference runs here with it replaced by its exact form: the top_c
    smallest, ties to the lowest column, the port's rule."""
    a, b = _tied_u8(seed)
    proj = jm.make_hash_projections(jax.random.PRNGKey(seed))
    mean = jnp.asarray(a.mean(0), jnp.float32)
    va = np.arange(len(a)) < len(a) - 7
    vb = np.arange(len(b)) < len(b) - 11
    monkeypatch.setattr(jax.lax, "approx_min_k", _exact_min_k)
    cascade = jax.jit(jm.match_cascade.__wrapped__, static_argnames=("ratio", "top_c"))
    ref = cascade(jnp.asarray(a), jnp.asarray(b), proj, mean, jnp.asarray(va), jnp.asarray(vb),
                  top_c=16)
    tp, tmean = (torch.as_tensor(np.array(x, np.float32)) for x in (proj, mean))
    got = tm.match_cascade(torch.as_tensor(a), torch.as_tensor(b), tp, tmean,
                           torch.as_tensor(va), torch.as_tensor(vb), top_c=16)
    sb = tm.sign_codes(torch.as_tensor(b), tp, tmean)
    ham = (128 - sb @ sb.T) * 0.5
    assert int((ham[:, None, :] == ham[:, :, None]).sum()) > len(b) ** 3 // 20   # many ties
    np.testing.assert_array_equal(got.idx_b.numpy(), np.asarray(ref.idx_b))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
    assert got.mask.sum() >= 15     # the duplicated rows fail the ratio


def test_cascade_pair_batches_equal_single_pairs():
    """match_descriptor_lists("cascade") over several pairs of ragged views
    (batches of every size) equals match_cascade pair by pair."""
    rng = np.random.default_rng(2)
    descs = [rng.integers(0, 256, size=(n, 128)).astype(np.uint8) for n in (70, 40, 90, 25)]
    descs[1][:30] = descs[0][10:40]
    pairs = [(0, 1), (0, 2), (1, 3), (2, 3), (1, 2)]
    proj = tm.make_hash_projections(0)
    mean = torch.as_tensor(descs[0].mean(0).astype(np.float32))
    old = tm.CASCADE_BATCH_BYTES
    try:
        for budget in (1, old):
            tm.CASCADE_BATCH_BYTES = budget
            got = tm.match_descriptor_lists(descs, pairs, 0.8, "cpu", method="cascade",
                                            proj=proj, mean=mean)
            for i, j in pairs:
                r = tm.match_cascade(torch.as_tensor(descs[i]), torch.as_tensor(descs[j]),
                                     proj, mean)
                sel = np.nonzero(r.mask.numpy())[0]
                want = np.stack([sel, r.idx_b.numpy()[sel]], 1)
                np.testing.assert_array_equal(got.get((i, j), np.zeros((0, 2))), want)
    finally:
        tm.CASCADE_BATCH_BYTES = old
    assert len(got[(0, 1)]) >= 25


def test_cascade_recall_vs_bruteforce():
    """tests/test_matching.py::test_cascade_recall_vs_bruteforce on the
    port, with the port's own hyperplanes."""
    rng = np.random.default_rng(3)
    base = rng.normal(size=(500, 128)).astype(np.float32)
    noisy = base + rng.normal(scale=0.05, size=base.shape).astype(np.float32)
    proj = tm.make_hash_projections(0)
    mean = torch.as_tensor(base.mean(axis=0))
    bf = tm.match_brute_force(torch.as_tensor(base), torch.as_tensor(noisy))
    ch = tm.match_cascade(torch.as_tensor(base), torch.as_tensor(noisy), proj, mean, top_c=16)
    bf_pairs = {(i, int(j)) for i, (j, m) in enumerate(zip(bf.idx_b, bf.mask)) if m}
    ch_pairs = {(i, int(j)) for i, (j, m) in enumerate(zip(ch.idx_b, ch.mask)) if m}
    assert len(bf_pairs & ch_pairs) / max(len(bf_pairs), 1) > 0.95


def test_kdtree_matches_bruteforce():
    """tests/test_matching.py::test_kdtree_matches_bruteforce on the port,
    and the reference's kd-tree matches equal."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, size=(90, 128)).astype(np.uint8)
    b = rng.integers(0, 256, size=(110, 128)).astype(np.uint8)
    b[10:40] = a[5:35] + rng.integers(0, 3, size=(30, 128)).astype(np.uint8)
    res = tm.match_brute_force(torch.as_tensor(a), torch.as_tensor(b), ratio=0.8)
    mask = res.mask.numpy()
    bf = np.stack([np.nonzero(mask)[0], res.idx_b.numpy()[mask]], 1)
    kd = tm.match_kdtree(a, b, ratio=0.8)
    assert len(kd) > 20
    assert np.array_equal(np.sort(bf, 0), np.sort(kd, 0))
    np.testing.assert_array_equal(kd, jm.match_kdtree(a, b, ratio=0.8))


@pytest.mark.parametrize("nbytes", [32, 61])
def test_hamming_equals_reference(nbytes):
    """Random packed bits with planted near copies and duplicated columns,
    and padding masks: the same idx_b, mask and dist exactly."""
    rng = np.random.default_rng(nbytes)
    a = rng.integers(0, 256, size=(70, nbytes), dtype=np.uint8)
    b = rng.integers(0, 256, size=(80, nbytes), dtype=np.uint8)
    b[:40] = a[rng.permutation(70)[:40]]
    b[:40, 0] ^= rng.integers(0, 8, 40).astype(np.uint8)
    b[60:70] = b[:10]
    va = np.arange(70) < 66
    vb = np.arange(80) < 77
    ref = jm.match_brute_force_hamming(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va),
                                       jnp.asarray(vb), ratio=0.8)
    got = tm.match_brute_force_hamming(torch.as_tensor(a), torch.as_tensor(b),
                                       torch.as_tensor(va), torch.as_tensor(vb), ratio=0.8)
    np.testing.assert_array_equal(got.idx_b.numpy(), np.asarray(ref.idx_b))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
    assert got.mask.sum() >= 20


def test_hamming_matcher_finds_permutation():
    """tests/test_more_components.py (brute-force Hamming) on the port."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, size=(60, 60), dtype=np.uint8)
    perm = rng.permutation(60)
    b = a[perm].copy()
    b[:, 0] ^= 1
    res = tm.match_brute_force_hamming(torch.as_tensor(a), torch.as_tensor(b), ratio=0.9)
    m = res.mask.numpy()
    inv = np.empty(60, np.int64)
    inv[perm] = np.arange(60)
    assert m.sum() > 55
    np.testing.assert_array_equal(res.idx_b.numpy()[m], inv[m])
