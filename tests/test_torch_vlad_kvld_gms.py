"""Port parity for VLAD retrieval, GMS and K-VLD, openmvg_torch against
openmvg_tpu on the same numpy inputs, on the CPU.

VLAD: Lloyd's iterations from the same initial centres (carried across
as a float32 tensor) reach the same assignments and centres to
1e-5 (float32 sums in another order: K2's plain version here, segment_sum
there); the embeddings agree to 1e-6 and the retrieved pairs are equal.
GMS (numpy in both) keeps the same matches.  K-VLD: the reference's three
cases on the port, and on a case without exact ties the same kept matches,
validity and scores to 1e-9 (the VLD extraction in float64 in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from openmvg_tpu.ops import gms as jgms
from openmvg_tpu.ops import kvld as jkvld
from openmvg_tpu.ops import vlad as jvlad
from openmvg_torch.ops import gms as tgms
from openmvg_torch.ops import kvld as tkvld
from openmvg_torch.ops import vlad as tvlad
from tests.test_kvld import _pair


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs on several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clustered(seed, n=900, k=8):
    """SIFT-like u8 rows around k well-separated centres, as float32."""
    rng = np.random.default_rng(seed)
    c = rng.integers(30, 226, size=(k, 128))
    return np.clip(c[rng.integers(0, k, n)] + rng.normal(scale=12.0, size=(n, 128)), 0,
                   255).astype(np.uint8).astype(np.float32)


# ---------------------------------------------------------------------------
# VLAD
# ---------------------------------------------------------------------------

def test_lloyd_from_the_same_centres_matches_reference():
    X = _clustered(0)
    init = X[np.random.default_rng(1).choice(len(X), 8, replace=False)]
    c_ref, a_ref = jvlad._lloyd(jnp.asarray(X), jnp.asarray(init), n_iter=25)
    c_got, a_got = tvlad._lloyd(torch.as_tensor(X), torch.as_tensor(init, dtype=torch.float32))
    np.testing.assert_array_equal(a_got.numpy(), np.asarray(a_ref))
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_ref), rtol=1e-5, atol=1e-5)
    assert len(np.unique(a_got.numpy())) >= 6


def test_kmeans_pp_seeding_and_codebook():
    """The port's own seeding picks k distinct rows; build_codebook's
    subsample above max_samples is the reference's, so both packages'
    codebooks agree from the same seeding."""
    X = _clustered(2, n=700)
    c0 = tvlad.kmeans_pp_init(torch.Generator().manual_seed(0), torch.as_tensor(X), 8)
    assert len({tuple(r) for r in c0.numpy()}) == 8
    assert all(any(np.array_equal(r, x) for x in X) for r in c0.numpy())

    def first_rows(_key, Xs, k):
        return Xs[:k]

    orig = jvlad.kmeans_pp_init, tvlad.kmeans_pp_init
    try:
        jvlad.kmeans_pp_init, tvlad.kmeans_pp_init = first_rows, first_rows
        ref = jvlad.build_codebook(jax.random.PRNGKey(0), X, k=8, max_samples=500)
        got = tvlad.build_codebook(None, X, k=8, max_samples=500, device="cpu")
    finally:
        jvlad.kmeans_pp_init, tvlad.kmeans_pp_init = orig
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_vlad_embeddings_and_retrieval_match_reference():
    rng = np.random.default_rng(3)
    X = _clustered(3, n=800)
    centers = X[rng.choice(len(X), 8, replace=False)]
    descs = [X[rng.choice(len(X), n, replace=False)].astype(np.uint8)
             for n in (60, 90, 40, 75, 120, 50, 0, 66)]
    ref = np.stack([np.asarray(jvlad.vlad_embedding(jnp.asarray(d), jnp.asarray(centers)))
                    for d in descs])
    got = tvlad.vlad_embeddings(descs, centers, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    one = tvlad.vlad_embedding(torch.as_tensor(descs[1]), torch.as_tensor(centers)).numpy()
    np.testing.assert_allclose(one, ref[1], atol=1e-6)
    for top_k in (2, 3, 10):
        assert tvlad.retrieve_pairs(got, top_k) == jvlad.retrieve_pairs(ref, top_k)


def test_vlad_cluster_sums_go_through_k2_in_64_column_blocks(monkeypatch):
    """A 128-wide sum is two seg_sum calls of 64 columns (K2 takes at most
    64), each the plain sum on the CPU."""
    calls = []
    real = tvlad.ss.seg_sum

    def spy(vals, ids, num, plan=None):
        calls.append(vals.shape)
        return real(vals, ids, num, plan)

    monkeypatch.setattr(tvlad.ss, "seg_sum", spy)
    vals = torch.as_tensor(np.random.default_rng(4).normal(size=(50, 128)))
    ids = torch.as_tensor(np.random.default_rng(5).integers(0, 6, 50))
    got = tvlad.cluster_sums(vals, ids, 6)
    assert calls == [(50, 64), (50, 64)]
    want = np.zeros((6, 128))
    np.add.at(want, ids.numpy(), vals.numpy())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


# ---------------------------------------------------------------------------
# GMS
# ---------------------------------------------------------------------------

def _gms_case(seed):
    rng = np.random.default_rng(seed)
    n_good, n_bad = 400, 60
    xa_good = rng.uniform(50, 450, size=(n_good, 2))
    xa = np.concatenate([xa_good, rng.uniform(0, 500, size=(n_bad, 2))])
    xb = np.concatenate([xa_good + [30.0, 10.0], rng.uniform(0, 500, size=(n_bad, 2))])
    return xa, xb, n_good


@pytest.mark.parametrize("seed", [0, 1])
def test_gms_keeps_coherent_rejects_random(seed):
    """tests/test_gms_gt_loaders.py::test_gms_keeps_coherent_rejects_random
    on the port, and the reference's keep mask equal."""
    xa, xb, n_good = _gms_case(seed)
    keep = tgms.gms_filter(xa, xb, (500, 500), (500, 500))
    assert keep[:n_good].mean() > 0.8
    assert keep[n_good:].mean() < 0.25
    np.testing.assert_array_equal(keep, jgms.gms_filter(xa, xb, (500, 500), (500, 500)))
    feats = [np.c_[xa, np.ones((len(xa), 2))], np.c_[xb, np.ones((len(xb), 2))]]
    m = {(0, 1): np.stack([np.arange(len(xa))] * 2, 1)}
    got = tgms.gms_filter_matches(m, feats, lambda v: (500, 500))
    ref = jgms.gms_filter_matches(m, feats, lambda v: (500, 500))
    np.testing.assert_array_equal(got[(0, 1)], ref[(0, 1)])


# ---------------------------------------------------------------------------
# K-VLD
# ---------------------------------------------------------------------------

def test_kvld_keeps_true_kills_false():
    """tests/test_kvld.py::test_kvld_keeps_true_kills_false on the port."""
    base, img2, f1, f2, n = _pair()
    good = np.stack([np.arange(n), np.arange(n)], 1)
    bad_i = np.arange(0, n, 7)
    bad_j = (bad_i + n // 2 + 3) % n
    matches = np.concatenate([good, np.stack([bad_i, bad_j], 1)])
    _, _, valid = tkvld.kvld_filter(base, img2, f1, f2, matches, device="cpu")
    assert valid[:n].sum() >= 0.8 * n
    assert valid[n:].sum() == 0


def test_vld_identical_segments_have_zero_difference():
    rng = np.random.default_rng(1)
    img = ndimage.gaussian_filter(rng.uniform(0, 255, (128, 128)), 2.0)
    pyr = tkvld.pyramid_on(tkvld.build_image_scale(img), "cpu")
    p1 = torch.tensor([[30.0, 40.0]], dtype=torch.float64)
    p2 = torch.tensor([[90.0, 70.0]], dtype=torch.float64)
    assert abs(float(tkvld.vld_pair_diff(pyr, pyr, p1, p2, p1, p2)[0])) < 1e-6


def test_vld_contrast_gate():
    """Flat image -> zero gradient -> contrast 0 -> difference 128."""
    pyr = tkvld.pyramid_on(tkvld.build_image_scale(np.full((96, 96), 128.0)), "cpu")
    p1 = torch.tensor([[20.0, 20.0]], dtype=torch.float64)
    p2 = torch.tensor([[70.0, 60.0]], dtype=torch.float64)
    assert float(tkvld.vld_pair_diff(pyr, pyr, p1, p2, p1, p2)[0]) == 128.0


def test_kvld_filter_equals_reference():
    """Sub-pixel feature positions (no exactly symmetric windows, whose
    tied histogram bins either package may break either way), a rotated
    and shifted second image, and planted outliers: the same kept matches,
    validity and scores."""
    rng = np.random.default_rng(6)
    base = ndimage.gaussian_filter(rng.uniform(0, 255, (180, 220)), 2.0)
    img2 = ndimage.shift(base, (4.3, -6.7), order=1, mode="nearest")
    n = 40
    xy1 = np.c_[rng.uniform(30, 190, n), rng.uniform(30, 150, n)]
    xy2 = xy1 + [-6.7, 4.3]
    f1 = dict(xy=xy1, scale=rng.uniform(1.5, 3.0, n), orientation=rng.uniform(0, 0.2, n))
    f2 = dict(xy=xy2, scale=f1["scale"] * 1.02, orientation=f1["orientation"] + 0.01)
    bad = rng.choice(n, 8, replace=False)
    matches = np.concatenate([np.stack([np.arange(n)] * 2, 1),
                              np.stack([bad, (bad + 11) % n], 1)])
    ref = jkvld.kvld_filter(base, img2, f1, f2, matches)
    got = tkvld.kvld_filter(base, img2, f1, f2, matches, device="cpu")
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    np.testing.assert_array_equal(got[2], np.asarray(ref[2]))
    np.testing.assert_allclose(got[1], np.asarray(ref[1]), rtol=1e-9, atol=1e-9)
    assert got[2][:n].sum() >= n // 2 and got[2][n:].sum() == 0
