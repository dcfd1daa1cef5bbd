"""Port parity for the geometric filter's other models and guided matching:
the homography, upright and orthographic solvers, the four robust
estimators (h, a, u, o) and geometric_filter on them, openmvg_torch against
openmvg_tpu on the same numpy inputs, float64 on the CPU.

Tolerances: the solvers agree to 1e-9 with the planted model on exact data
(H and the upright E up to sign), and to 1e-6 with the reference, whose
null vectors come from eigh of A^T A; the ortho solver and the errors
agree with the reference to 1e-9.
AC-RANSAC fed one Gumbel table for both packages agrees on the found flag
and the inlier set, the NFA and threshold to 1e-6 (the models differ by the
reference's eigh null vectors).  geometric_filter draws from each
package's own random streams, so it is held to the rule of the "e" test in
tests/test_torch_global.py: the same pairs, inlier sets that share 95% of
the larger one, and the reference test's own bounds on the true and the
planted false correspondences kept.  Guided matching through the batched
K1 route equals the reference's per-pair guided_matching_pair exactly for
the same F.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmvg_tpu.ops import essential as jess
from openmvg_tpu.ops import homography as jhom
from openmvg_tpu.sfm import geometric_filter as jgf
from openmvg_tpu.sfm import known_poses as jkp
from openmvg_tpu.sfm import robust as jrobust
from openmvg_tpu.utils.synthetic import ring_scene
from openmvg_torch.io import from_reference
from openmvg_torch.ops import essential as tess
from openmvg_torch.ops import homography as thom
from openmvg_torch.sfm import geometric_filter as tgf
from openmvg_torch.sfm import known_poses as tkp
from openmvg_torch.sfm import robust as trobust
from tests.test_geometric_filter_models import _mk_matches, _roty, _two_view_scene
from tests.test_incremental import scene_and_data
from tests.test_torch_incremental import _with_table


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs on several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _canon(M):
    """Unit norm, sign fixed by the largest entry."""
    M = np.asarray(M) / np.linalg.norm(M)
    return M * np.sign(M.reshape(-1)[np.argmax(np.abs(M))])


def _bear(x, f=800.0, c=500.0):
    b = np.c_[(x - c) / f, np.ones(len(x))]
    return b / np.linalg.norm(b, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

def test_homography_4pt_matches_reference():
    """Exact data: the port's H to 1e-9 of the planted one, the reference's
    to 1e-6 (its null vector comes from eigh of A^T A, which squares the
    condition number; the port's from Gauss-Jordan elimination)."""
    rng = np.random.default_rng(0)
    x1 = rng.uniform(-1, 1, (50, 4, 2))
    H = np.eye(3) + 0.2 * rng.normal(size=(50, 3, 3))
    x2h = np.einsum("bij,bnj->bni", H, np.c_[x1.reshape(-1, 2), np.ones(200)].reshape(50, 4, 3))
    x2 = x2h[..., :2] / x2h[..., 2:]
    ref = np.array(jhom.solve_homography(jnp.asarray(x1), jnp.asarray(x2)))
    got = thom.solve_homography(torch.as_tensor(x1), torch.as_tensor(x2)).numpy()
    for a, b, h in zip(got, ref, H):
        np.testing.assert_allclose(_canon(a), _canon(h), atol=1e-9)
        np.testing.assert_allclose(_canon(a), _canon(b), atol=1e-6)
    e_ref = np.asarray(jhom.asymmetric_error_sq(jnp.asarray(ref), jnp.asarray(x1),
                                                jnp.asarray(x2)))
    e_got = thom.asymmetric_error_sq(torch.as_tensor(ref), torch.as_tensor(x1),
                                     torch.as_tensor(x2)).numpy()
    np.testing.assert_allclose(e_got, e_ref, rtol=1e-9, atol=1e-18)


def test_upright_3pt_matches_reference():
    """Up to scale and sign: the port's E to 1e-9 of the planted [t]x R
    (closed-form minors), the reference's to 1e-6 (eigh of A^T A)."""
    rng = np.random.default_rng(1)
    B = 64
    th = rng.uniform(-0.3, 0.3, B)
    t = np.c_[rng.normal(size=B), np.zeros(B), rng.normal(size=B)]
    X = rng.uniform(-1, 1, (B, 3, 3)) + [0, 0, 5.0]
    R = np.stack([_roty(a) for a in th])
    b1 = X / np.linalg.norm(X, axis=-1, keepdims=True)
    X2 = np.einsum("bij,bnj->bni", R, X) + t[:, None]
    b2 = X2 / np.linalg.norm(X2, axis=-1, keepdims=True)
    ref = np.asarray(jess.solve_essential_upright_3pt(jnp.asarray(b1), jnp.asarray(b2)))
    got, ok = tess.solve_essential_upright_3pt(torch.as_tensor(b1), torch.as_tensor(b2))
    assert bool(ok.all())
    for a, b, ti, Ri in zip(got.numpy(), ref, t, R):
        tx = np.array([[0, -ti[2], ti[1]], [ti[2], 0, -ti[0]], [-ti[1], ti[0], 0]])
        np.testing.assert_allclose(_canon(a), _canon(tx @ Ri), atol=1e-9)
        np.testing.assert_allclose(_canon(a), _canon(b), atol=1e-6)


def test_ortho_3pt_and_error_match_reference():
    """Both candidates and their masks; some samples are degenerate."""
    rng = np.random.default_rng(2)
    x1 = rng.uniform(-0.3, 0.3, (400, 3, 2))
    x2 = x1 @ np.array([[0.9, -0.3], [0.3, 0.9]]).T + rng.normal(scale=0.05, size=x1.shape)
    pts = rng.uniform(-0.3, 0.3, (400, 20, 2))
    x1[:5, 2] = x1[:5, 1]                 # collinear samples: denom 0
    E_ref, ok_ref = jess.solve_essential_ortho_3pt(jnp.asarray(x1), jnp.asarray(x2))
    E_got, ok_got = tess.solve_essential_ortho_3pt(torch.as_tensor(x1), torch.as_tensor(x2))
    ok_ref = np.asarray(ok_ref)
    np.testing.assert_array_equal(ok_got.numpy(), ok_ref)
    assert 0 < ok_ref.sum() < ok_ref.size
    E_ref = np.array(E_ref)
    np.testing.assert_allclose(E_got.numpy()[ok_ref], E_ref[ok_ref], rtol=1e-9, atol=1e-9)
    pts2 = pts[:, ::-1].copy()
    e_ref = np.asarray(jess.ortho_essential_error_sq(jnp.asarray(E_ref[:, 0]), jnp.asarray(pts),
                                                      jnp.asarray(pts2)))
    e_got = tess.ortho_essential_error_sq(torch.as_tensor(E_ref[:, 0]), torch.as_tensor(pts),
                                          torch.as_tensor(pts2)).numpy()
    np.testing.assert_allclose(e_got, e_ref, rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# robust estimators: one Gumbel table for both packages
# ---------------------------------------------------------------------------

def _upright_pair(n=100, n_out=25, seed=3, plane=False, ortho=False, noise_px=0.3):
    rng = np.random.default_rng(seed)
    f, wh = 800.0, 1000
    if ortho:
        R = _roty(np.radians(10.0))
        X = rng.uniform(-0.3, 0.3, (n, 3))
        xa, xb = X[:, :2] * f + wh / 2, (X @ R.T + [0.05, -0.02, 0])[:, :2] * f + wh / 2
    else:
        X = rng.uniform(-1, 1, (n, 3)) + [0, 0, 5.0]
        if plane:
            X[:, 2] = 0.2 * X[:, 0] + 5.0
        Xc = (X - [0.6, 0.0, 0.1]) @ _roty(np.radians(8.0)).T
        xa, xb = X[:, :2] / X[:, 2:] * f + wh / 2, Xc[:, :2] / Xc[:, 2:] * f + wh / 2
    xb = xb + rng.normal(scale=noise_px, size=xb.shape)
    xa = np.concatenate([xa, rng.uniform(100, 900, (n_out, 2))])
    xb = np.concatenate([xb, rng.uniform(100, 900, (n_out, 2))])
    return xa, xb


@pytest.mark.parametrize("model", ["h", "a", "u", "o"])
def test_robust_estimator_same_draws_same_result(model, monkeypatch):
    xa, xb = _upright_pair(plane=model == "h", ortho=model == "o")
    n_samples = 128
    table = np.random.default_rng(9).gumbel(size=(n_samples, len(xa)))
    _with_table(monkeypatch, table, n_samples * 9 // 10)
    valid_j, valid_t = jnp.ones(len(xa), bool), torch.ones(len(xa), dtype=torch.bool)
    g = torch.as_tensor(table)
    key = jax.random.PRNGKey(0)

    def jit(fn):
        return jax.jit(fn.__wrapped__, static_argnames="n_samples")

    if model == "h":
        args = (xa, xb)
        ref = jit(jrobust.robust_homography)(key, *map(jnp.asarray, args), valid_j, 1000.0,
                                             1000.0, 1000.0, 1000.0, n_samples=n_samples,
                                             precision_sq=16.0)
        got = trobust.robust_homography(None, *map(torch.as_tensor, args), valid_t, 1000.0,
                                        1000.0, 1000.0, 1000.0, n_samples=n_samples,
                                        precision_sq=16.0, gumbel=g)
    elif model in ("a", "u"):
        args = (_bear(xa), _bear(xb))
        jfn = jrobust.robust_essential_angular if model == "a" else \
            jrobust.robust_essential_upright
        tfn = trobust.robust_essential_angular if model == "a" else \
            trobust.robust_essential_upright
        ref = jit(jfn)(key, *map(jnp.asarray, args), valid_j, n_samples=n_samples)
        got = tfn(None, *map(torch.as_tensor, args), valid_t, n_samples=n_samples, gumbel=g)
    else:
        args = ((xa - 500.0) / 800.0, (xb - 500.0) / 800.0)
        prec = 0.5 * (4.0 / 800.0 + 4.0 / 800.0)
        ref = jit(jrobust.robust_essential_ortho)(key, *map(jnp.asarray, args), valid_j, 1000.0,
                                                  1000.0, n_samples=n_samples,
                                                  precision_sq=prec)
        got = trobust.robust_essential_ortho(None, *map(torch.as_tensor, args), valid_t, 1000.0,
                                             1000.0, n_samples=n_samples, precision_sq=prec,
                                             gumbel=g)
    assert bool(got.found) and bool(ref.found)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(float(got.nfa), float(ref.nfa), rtol=1e-6)
    np.testing.assert_allclose(float(got.threshold_sq), float(ref.threshold_sq), rtol=1e-6)


# ---------------------------------------------------------------------------
# geometric_filter: the reference's cases on the port, against its result
# ---------------------------------------------------------------------------

def _compare(sc, feats, matches, model, n, n_out, true_share, out_share, **kw):
    ref = jgf.geometric_filter(sc, feats, matches, model=model, n_samples=512, seed=0, **kw)
    got = tgf.geometric_filter(from_reference(sc), feats, matches, model=model, n_samples=512,
                               seed=0, device="cpu", **kw)
    assert sorted(got) == sorted(ref) == [(0, 1)], model
    kept = got[(0, 1)][:, 0]
    n_true, n_false = np.sum(kept < n), np.sum(kept >= n)
    assert n_true > true_share * n, f"model {model}: only {n_true}/{n} inliers"
    assert n_false <= out_share * n_out + 2, f"model {model}: kept {n_false} outliers"
    a = {tuple(r) for r in got[(0, 1)]}
    b = {tuple(r) for r in np.asarray(ref[(0, 1)])}
    assert len(a & b) >= 0.95 * max(len(a), len(b))


@pytest.mark.parametrize("model", ["h", "a", "u"])
def test_filter_models_keep_the_reference_pairs(model):
    """tests/test_geometric_filter_models.py::
    test_filter_models_keep_inliers_reject_outliers on the port."""
    rng = np.random.default_rng(3)
    n, n_out = 120, 30
    f, wh = 800.0, 1000
    sc = _two_view_scene(f, wh)
    R = _roty(np.radians(8.0))
    C = np.array([0.6, 0.0, 0.1])
    if model == "h":
        X = np.concatenate([rng.uniform(-1, 1, (n, 2)), np.zeros((n, 1))], axis=1)
        X[:, 2] = 0.2 * X[:, 0] + 5.0
    else:
        X = rng.uniform(-1, 1, (n, 3)) + [0, 0, 5.0]

    def proj(Rw, Cw, X):
        Xc = (X - Cw) @ Rw.T
        return Xc[:, :2] / Xc[:, 2:] * f + wh / 2

    xa = np.concatenate([proj(np.eye(3), np.zeros(3), X), rng.uniform(100, 900, (n_out, 2))])
    xb = np.concatenate([proj(R, C, X), rng.uniform(100, 900, (n_out, 2))])
    _compare(sc, [xa, xb], _mk_matches(n, n_out, rng), model, n, n_out, 0.85, 0.1)


def test_filter_ortho_keeps_the_reference_pair():
    """tests/test_geometric_filter_models.py::test_filter_ortho_model on the
    port (threshold 2.0 px given, as there)."""
    rng = np.random.default_rng(5)
    n, n_out = 100, 25
    f, wh = 800.0, 1000
    sc = _two_view_scene(f, wh)
    R = _roty(np.radians(10.0)) @ np.array(
        [[np.cos(0.1), -np.sin(0.1), 0], [np.sin(0.1), np.cos(0.1), 0], [0, 0, 1.0]])
    t = np.array([0.05, -0.02, 0.0])
    X = rng.uniform(-0.3, 0.3, (n, 3))
    xa = np.concatenate([X[:, :2] * f + wh / 2, rng.uniform(300, 700, (n_out, 2))])
    xb = np.concatenate([(X @ R.T + t)[:, :2] * f + wh / 2, rng.uniform(300, 700, (n_out, 2))])
    _compare(sc, [xa, xb], _mk_matches(n, n_out, rng), "o", n, n_out, 0.8, 0.15,
             threshold_px=2.0)


def test_filter_many_pairs_batched_on_the_port():
    """tests/test_geometric_filter_models.py::test_filter_many_pairs_batched
    on the port: every admissible pair of several sizes comes back."""
    rng = np.random.default_rng(7)
    f, wh = 800.0, 1000
    V = 6
    sc = _two_view_scene(f, wh)
    sc.view_filename = [f"v{i}.jpg" for i in range(V)]
    sc.view_intrinsic = np.zeros(V, np.int32)
    sc.view_pose = np.arange(V, dtype=np.int32)
    sc.view_wh = np.tile([[wh, wh]], (V, 1)).astype(np.int32)
    sc.pose_valid = np.zeros(V, bool)
    sc.pose_R = np.tile(np.eye(3), (V, 1, 1))
    sc.pose_C = np.zeros((V, 3))
    X = rng.uniform(-1, 1, (200, 3)) + [0, 0, 6.0]
    feats = []
    for v in range(V):
        Xc = (X - [0.4 * v, 0.0, 0.0]) @ _roty(np.radians(4.0 * v)).T
        feats.append(Xc[:, :2] / Xc[:, 2:] * f + wh / 2)
    matches = {}
    sizes = [200, 150, 90, 60, 40, 200, 110]
    pairs = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (0, 2), (1, 3)]
    for (a, b), s in zip(pairs, sizes):
        sel = rng.permutation(200)[:s]
        matches[(a, b)] = np.stack([sel, sel], axis=1)
    out = tgf.geometric_filter(from_reference(sc), feats, matches, model="f", n_samples=512,
                               seed=1, device="cpu")
    assert set(out) == set(pairs)
    for p in pairs:
        assert len(out[p]) > 0.8 * len(matches[p])


def test_filter_ortho_default_precision_is_2px(monkeypatch):
    """Model o without a threshold runs at 2.0 px: each pair's camera-plane
    precision is 0.5 (4 / fa + 4 / fb); the other models keep 4.0 px."""
    seen = {}
    real = trobust.robust_essential_ortho_batch

    def spy(*args, **kw):
        seen["prec"] = args[6].numpy().copy()
        return real(*args, **kw)

    monkeypatch.setattr(trobust, "robust_essential_ortho_batch", spy)
    xa, xb = _upright_pair(ortho=True)
    sc = from_reference(_two_view_scene(800.0, 1000))
    m = {(0, 1): np.stack([np.arange(len(xa))] * 2, 1)}
    out = tgf.geometric_filter(sc, [xa, xb], m, model="o", n_samples=256, device="cpu")
    np.testing.assert_allclose(seen["prec"], [0.5 * (4.0 / 800.0 + 4.0 / 800.0)], rtol=1e-15)
    assert (0, 1) in out
    assert tgf.ORTHO_DEFAULT_PRECISION_PX == jgf.ORTHO_DEFAULT_PRECISION_PX == 2.0


# ---------------------------------------------------------------------------
# guided matching (-r)
# ---------------------------------------------------------------------------

def _guided_case():
    rng = np.random.default_rng(0)
    s = ring_scene(n_views=4, n_points=80, seed=0)
    sc, feats, matches = scene_and_data(s)
    base = rng.integers(0, 255, (80, 128)).astype(np.uint8)
    descs = [np.clip(base.astype(int) + rng.integers(-2, 3, base.shape), 0, 255).astype(np.uint8)
             for _ in range(4)]
    return sc, feats, descs, {k: m[::2] for k, m in matches.items()}


def test_guided_matching_filter_on_the_port():
    """tests/test_cli_tools.py::test_guided_matching_filter on the port: -r
    recovers most of the 80 correspondences that half the putative matches
    lost, and keeps the same pairs as the reference.  Each package gates at
    its own F's AC-RANSAC threshold, so the sets share 90% of the larger."""
    sc, feats, descs, sparse = _guided_case()
    tsc = from_reference(sc)
    plain = tgf.geometric_filter(tsc, feats, sparse, model="f", n_samples=512, device="cpu")
    guided = tgf.geometric_filter(tsc, feats, sparse, model="f", n_samples=512, guided=True,
                                  descs=descs, device="cpu")
    assert len(guided[(0, 1)]) > len(plain[(0, 1)])
    assert len(guided[(0, 1)]) >= 60
    ref = jgf.geometric_filter(sc, feats, sparse, model="f", n_samples=512, guided=True,
                               descs=descs)
    assert sorted(guided) == sorted(ref)
    for p in guided:
        a = {tuple(r) for r in guided[p]}
        b = {tuple(r) for r in np.asarray(ref[p])}
        assert len(a & b) >= 0.9 * max(len(a), len(b))


def test_guided_batch_equals_reference_pair_by_pair():
    """The batched K1 route over all pairs at once against the reference's
    guided_matching_pair one pair at a time, with the same F and threshold:
    the same match sets exactly."""
    sc, feats, descs, sparse = _guided_case()
    s = ring_scene(n_views=4, n_points=80, seed=0)
    sc.pose_valid[:] = True
    sc.pose_R, sc.pose_C = s.R.copy(), s.C.copy()
    pairs = [(i, j) for i in range(4) for j in range(i + 1, 4)]
    tsc = from_reference(sc)
    Fs = np.stack([tkp._pair_F(tsc, i, j) for i, j in pairs])
    thr = np.array([0.5, 1.0, 2.0, 4.0, 0.25, 3.0])
    got = tkp.guided_matching_batch(feats, descs, pairs, Fs, thr, device="cpu")
    for (i, j), F, t_, g in zip(pairs, Fs, thr, got):
        ref = jkp.guided_matching_pair(sc, i, j, feats[i], feats[j], descs[i], descs[j],
                                       epipolar_threshold_px=t_, F=F)
        np.testing.assert_array_equal(g, ref)
        np.testing.assert_allclose(F, jkp._pair_F(sc, i, j), rtol=1e-12, atol=1e-15)
    assert sum(len(g) for g in got) > 100
