"""Port parity for the geometry the incremental engine runs: so3, pose,
the six camera kinds, triangulation, the 5-point essential solver, P3P
and find_rts — openmvg_torch against openmvg_tpu on the same numpy inputs,
both in float64 on the CPU.

Tolerance 1e-9 relative unless a case says otherwise: the arithmetic is
the same, but the port takes its eigenvectors from Jacobi rotations and
its SVDs from them (ops/linalg.py), where the reference calls LAPACK, so
results agree to rounding of float64 and not bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmvg_tpu.geometry import pose as jpose
from openmvg_tpu.geometry import similarity as jsim
from openmvg_tpu.geometry import so3 as jso3
from openmvg_tpu.models import cameras as jcm
from openmvg_tpu.ops import essential as jess
from openmvg_tpu.ops import resection as jres
from openmvg_tpu.ops import triangulation as jtri
from openmvg_tpu.utils import hostmath as jhost
from openmvg_torch.geometry import pose as tpose
from openmvg_torch.geometry import similarity as tsim
from openmvg_torch.geometry import so3 as tso3
from openmvg_torch.models import cameras as tcm
from openmvg_torch.ops import essential as tess
from openmvg_torch.ops import linalg as tlin
from openmvg_torch.ops import resection as tres
from openmvg_torch.ops import triangulation as ttri
from openmvg_torch.utils import hostmath as thost


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs on several workers at once, and
    small tensors gain nothing from more threads than the cores allow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

RTOL = 1e-9


def T(a):
    return torch.as_tensor(np.asarray(a))


def close(got, ref, rtol=RTOL, atol=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def _rotations(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)) * scale


# ---------------------------------------------------------------------------
# so3 / pose / hostmath (the cases of tests/test_so3.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-6, 1e-3, 0.5, 2.0])
def test_so3_expmap_rotate_logmap(scale):
    w = _rotations(64, 0, scale)
    v = np.random.default_rng(1).normal(size=(64, 3))
    close(tso3.expmap(T(w)), jso3.expmap(jnp.asarray(w)))
    close(tso3.rotate(T(w), T(v)), jso3.rotate(jnp.asarray(w), jnp.asarray(v)))
    R = np.asarray(jso3.expmap(jnp.asarray(w)))
    close(tso3.logmap(T(R)), jso3.logmap(jnp.asarray(R)))
    close(thost.expmap_np(w), jhost.expmap_np(w))
    close(thost.logmap_np(R), jhost.logmap_np(R))


def test_so3_log_near_pi_and_identity():
    w = np.array([[np.pi - 1e-4, 0, 0], [0, 0, 0], [0, 1e-9, 0], [0.3, -3.1, 0.2]])
    R = np.asarray(jso3.expmap(jnp.asarray(w)))
    close(tso3.logmap(T(R)), jso3.logmap(jnp.asarray(R)))


def test_so3_project_angle_quat():
    """project_to_so3 goes through the port's svd3: rounding-level
    agreement (1e-9) with LAPACK's SVD."""
    rng = np.random.default_rng(3)
    M = np.asarray(jso3.expmap(jnp.asarray(_rotations(16, 2)))) + 0.05 * rng.normal(size=(16, 3, 3))
    close(tso3.project_to_so3(T(M)), jso3.project_to_so3(jnp.asarray(M)))
    Ra = np.asarray(jso3.expmap(jnp.asarray(_rotations(16, 4))))
    Rb = np.asarray(jso3.expmap(jnp.asarray(_rotations(16, 5))))
    close(tso3.relative_rotation_angle_deg(T(Ra), T(Rb)),
          jso3.relative_rotation_angle_deg(jnp.asarray(Ra), jnp.asarray(Rb)))
    q = rng.normal(size=(8, 4))
    close(tso3.quat_to_rot(T(q)), jso3.quat_to_rot(jnp.asarray(q)))


def test_so3_jacobian_finite_at_zero():
    from torch.func import jacfwd

    J = jacfwd(lambda w: tso3.rotate(w, torch.tensor([1.0, 2.0, 3.0], dtype=w.dtype)))(
        torch.zeros(3, dtype=torch.float64))
    assert torch.isfinite(J).all()


def test_pose_ops():
    R = np.asarray(jso3.expmap(jnp.asarray(_rotations(5, 6))))
    C = np.random.default_rng(7).normal(size=(5, 3))
    X = np.random.default_rng(8).normal(size=(5, 3))
    pj = jpose.Pose(jnp.asarray(R), jnp.asarray(C))
    pt = tpose.Pose(T(R), T(C))
    close(pt.t, pj.t)
    close(pt.apply(T(X)), pj.apply(jnp.asarray(X)))
    close(pt.inverse().C, pj.inverse().C)
    close(pt.compose(pt.inverse()).C, pj.compose(pj.inverse()).C)
    close(tpose.relative_pose(pt, tpose.Pose(T(R[::-1].copy()), T(C[::-1].copy()))).R,
          jpose.relative_pose(pj, jpose.Pose(jnp.asarray(R[::-1]), jnp.asarray(C[::-1]))).R)
    close(tpose.pose_from_Rt(T(R), T(C)).C, jpose.pose_from_Rt(jnp.asarray(R), jnp.asarray(C)).C)


# ---------------------------------------------------------------------------
# cameras (the cases of tests/test_cameras.py), all six kinds
# ---------------------------------------------------------------------------

MODELS = [
    (jcm.PINHOLE, ()),
    (jcm.PINHOLE_RADIAL_K1, (0.1,)),
    (jcm.PINHOLE_RADIAL_K3, (-0.2, 0.01, 0.001)),
    (jcm.PINHOLE_BROWN, (-0.05, 0.01, 0.001, 0.002, -0.001)),
    (jcm.PINHOLE_FISHEYE, (-0.05, 0.01, -0.01, 0.005)),
    (jcm.SPHERICAL, ()),
]


@pytest.mark.parametrize("kind,disto", MODELS)
def test_camera_functions(kind, disto):
    c = jcm.make_pinhole(1000, 800, 1200.0, 510.0, 390.0, kind=kind, disto=disto)
    rng = np.random.default_rng(kind)
    p = rng.uniform(-0.4, 0.4, size=(300, 2))
    pix = rng.uniform(0, [1000, 800], size=(300, 2))
    Xc = np.c_[rng.uniform(-1, 1, (300, 2)), rng.uniform(2, 5, 300)]
    kj, kt = jnp.full((), kind, jnp.int32), torch.tensor(kind, dtype=torch.int32)
    pr, w, h = c.params[0], c.width[0], c.height[0]
    J = (kj, jnp.asarray(pr), jnp.asarray(w), jnp.asarray(h))
    Tt = (kt, T(pr), T(w), T(h))
    close(tcm.add_disto(kt, T(pr), T(p)), jcm.add_disto(kj, jnp.asarray(pr), jnp.asarray(p)))
    close(tcm.remove_disto(kt, T(pr), T(p)),
          jcm.remove_disto(kj, jnp.asarray(pr), jnp.asarray(p)))
    close(tcm.cam2ima(*Tt, T(p)), jcm.cam2ima(*J, jnp.asarray(p)))
    close(tcm.ima2cam(*Tt, T(pix)), jcm.ima2cam(*J, jnp.asarray(pix)))
    close(tcm.project_cam(*Tt, T(Xc)), jcm.project_cam(*J, jnp.asarray(Xc)))
    close(tcm.bearing(*Tt, T(pix)), jcm.bearing(*J, jnp.asarray(pix)))
    ref_r = np.array(jcm.residual(*J, jnp.asarray(Xc), jnp.asarray(pix)))
    if kind == jcm.SPHERICAL:
        # the port wraps a SPHERICAL view's x difference into one turn,
        # max(w, h) pixels (ROADMAP.md, fault 3.5); the reference does not
        turn = max(w, h)
        ref_r[:, 0] -= turn * np.round(ref_r[:, 0] / turn)
        assert np.abs(ref_r[:, 0]).max() <= turn / 2
    close(tcm.residual(*Tt, T(Xc), T(pix)), ref_r)
    close(thost.residual_np(kind, pr, w, h, Xc, pix), ref_r)
    close(tcm.image_plane_to_camera_plane_error(*Tt, torch.tensor(4.0, dtype=torch.float64)),
          jcm.image_plane_to_camera_plane_error(*J, 4.0))
    # round trips of tests/test_cameras.py
    und = tcm.remove_disto(kt, T(pr), tcm.add_disto(kt, T(pr), T(p)))
    close(und, p, rtol=0, atol=1e-6)
    close(thost.project_cam_np(kind, pr, w, h, Xc), jhost.project_cam_np(kind, pr, w, h, Xc))


def test_cameras_mixed_batch():
    """One call over rows of different kinds (dense select)."""
    kinds = np.array([k for k, _ in MODELS], np.int32)
    params = np.stack([jcm.make_pinhole(900, 700, 1000.0, kind=k, disto=d).params[0]
                       for k, d in MODELS])
    w, h = np.full(6, 900.0), np.full(6, 700.0)
    Xc = np.random.default_rng(9).uniform([-1, -1, 2], [1, 1, 4], (6, 3))
    close(tcm.project_cam(T(kinds), T(params), T(w), T(h), T(Xc)),
          jcm.project_cam(jnp.asarray(kinds), jnp.asarray(params), jnp.asarray(w),
                          jnp.asarray(h), jnp.asarray(Xc)))


# ---------------------------------------------------------------------------
# triangulation, 5-point essential, P3P, find_rts
# ---------------------------------------------------------------------------

def _two_cams(seed, n):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1, -1, 4], [1, 1, 6], (n, 3))
    R0 = np.asarray(jso3.expmap(jnp.asarray(rng.normal(size=3) * 0.05)))
    R1 = np.asarray(jso3.expmap(jnp.asarray(rng.normal(size=3) * 0.1)))
    t0 = rng.normal(size=3) * 0.1
    t1 = np.array([-1.0, 0.1, 0.05])
    Xc0 = X @ R0.T + t0
    Xc1 = X @ R1.T + t1
    b0 = Xc0 / np.linalg.norm(Xc0, axis=1, keepdims=True)
    b1 = Xc1 / np.linalg.norm(Xc1, axis=1, keepdims=True)
    b1 = b1 + rng.normal(size=b1.shape) * 1e-4       # not exactly consistent
    return X, R0, t0, b0, R1, t1, b1


@pytest.mark.parametrize("method", [0, 1, 2, 3])
def test_triangulate_2view(method):
    X, R0, t0, b0, R1, t1, b1 = _two_cams(10, 50)
    n = len(X)
    args = [np.broadcast_to(a, (n,) + a.shape) if a.ndim < 2 or a.shape[0] != n else a
            for a in (R0, t0, b0, R1, t1, b1)]
    Xt, okt = ttri.triangulate_2view(*[T(np.ascontiguousarray(a)) for a in args], method=method)
    Xj, okj = jtri.triangulate_2view(*[jnp.asarray(a) for a in args], method=method)
    close(Xt, Xj, rtol=1e-8)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))


def test_triangulate_nview():
    rng = np.random.default_rng(11)
    V, N = 5, 40
    X = rng.uniform([-1, -1, 4], [1, 1, 6], (N, 3))
    Rs = np.asarray(jso3.expmap(jnp.asarray(rng.normal(size=(N, V, 3)) * 0.1)))
    ts = rng.normal(size=(N, V, 3)) * 0.5
    Xc = np.einsum("nvij,nj->nvi", Rs, X) + ts
    b = Xc / np.linalg.norm(Xc, axis=-1, keepdims=True) + rng.normal(size=Xc.shape) * 1e-4
    w = (rng.uniform(size=(N, V)) > 0.3).astype(float)
    w[:, :2] = 1.0
    Xt, okt = ttri.triangulate_nview(T(Rs), T(ts), T(b), T(w))
    Xj, okj = jtri.triangulate_nview(jnp.asarray(Rs), jnp.asarray(ts), jnp.asarray(b),
                                     jnp.asarray(w))
    close(Xt, Xj, rtol=1e-8)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))


def _canon(E):
    E = E / np.linalg.norm(E)
    return E * np.sign(E.reshape(-1)[np.argmax(np.abs(E))])


def test_essential_5pt_same_solutions():
    """The solution sets, up to scale and sign, on 40 random problems.

    The port's null-space basis differs from the reference's eigh basis
    (ops/essential._generic_basis), so the degree-10 polynomials differ,
    and the bisection grid brackets different roots: on these problems
    the reference misses real solutions that the port finds.  So: every
    solution of the port satisfies the essential constraints and the five
    epipolar equations to 1e-7 (a root of a nearly double pair is only
    found to about the square root of float64 rounding); every reference
    solution is among the port's (1e-6) in at least 90% of problems; the port finds the true E
    in at least 38 of the 40 problems and in no fewer than the reference.
    (Both bracket roots on a grid, so two real roots closer than a grid
    cell are lost: over 200 such problems the reference missed the true E
    in 74, the port in 2.)"""
    rng = np.random.default_rng(12)
    probs = []
    for _ in range(40):
        X = rng.uniform([-1, -1, 4], [1, 1, 6], (5, 3))
        R1 = np.asarray(jso3.expmap(jnp.asarray(rng.normal(size=3) * 0.1)))
        t1 = rng.normal(size=3)
        Xc1 = X @ R1.T + t1
        probs.append((X / np.linalg.norm(X, axis=1, keepdims=True),
                      Xc1 / np.linalg.norm(Xc1, axis=1, keepdims=True), R1, t1))
    b0s = np.stack([q[0] for q in probs])
    b1s = np.stack([q[1] for q in probs])
    Ej, vj = (np.asarray(a) for a in jess.solve_essential_5pt(jnp.asarray(b0s),
                                                              jnp.asarray(b1s)))
    Et, vt = (a.numpy() for a in tess.solve_essential_5pt(T(b0s), T(b1s)))
    contained = found_t = found_j = 0
    for i, (b0, b1, R1, t1) in enumerate(probs):
        sols_j = [_canon(E) for E in Ej[i][vj[i]]]
        sols_t = [_canon(E) for E in Et[i][vt[i]]]
        for E in sols_t:
            assert abs(np.linalg.det(E)) < 1e-7
            assert np.abs(2 * E @ E.T @ E - np.trace(E @ E.T) * E).max() < 1e-7
            assert np.abs(np.einsum("ni,ij,nj->n", b1, E, b0)).max() < 1e-7
        contained += all(min(np.abs(a - b).max() for b in sols_t) < 1e-6 for a in sols_j)
        tx = np.array([[0, -t1[2], t1[1]], [t1[2], 0, -t1[0]], [-t1[1], t1[0], 0]])
        E_true = _canon(tx @ R1)
        found_t += min([np.abs(E - E_true).max() for E in sols_t] or [1.0]) < 1e-6
        found_j += min([np.abs(E - E_true).max() for E in sols_j] or [1.0]) < 1e-6
    assert contained >= 36
    assert found_t >= max(38, found_j)


def test_relative_pose_from_essential_and_motions():
    X, R0, t0, b0, R1, t1, _ = _two_cams(13, 30)
    Rrel = R1 @ R0.T
    trel = t1 - Rrel @ t0
    tx = np.array([[0, -trel[2], trel[1]], [trel[2], 0, -trel[0]], [-trel[1], trel[0], 0]])
    E = tx @ Rrel
    Xc1 = X @ R1.T + t1
    b1 = Xc1 / np.linalg.norm(Xc1, axis=1, keepdims=True)
    Rt, tt, nt = tess.relative_pose_from_essential(T(E), T(b0), T(b1))
    Rj, tj, nj = jess.relative_pose_from_essential(jnp.asarray(E), jnp.asarray(b0),
                                                   jnp.asarray(b1))
    close(Rt, Rj, rtol=1e-8, atol=1e-10)
    close(tt, tj, rtol=1e-8, atol=1e-10)
    assert float(nt) == float(nj) == 30


def test_p3p_and_kabsch():
    rng = np.random.default_rng(14)
    B = 16
    X = rng.uniform([-1, -1, 4], [1, 1, 6], (B, 3, 3))
    R = np.asarray(jso3.expmap(jnp.asarray(rng.normal(size=(B, 3)) * 0.2)))
    t = rng.normal(size=(B, 3)) * 0.3
    Xc = np.einsum("bij,bnj->bni", R, X) + t[:, None]
    b = Xc / np.linalg.norm(Xc, axis=-1, keepdims=True)
    Rt, tt, vt = tres.solve_p3p(T(b), T(X))
    Rj, tj, vj = jres.solve_p3p(jnp.asarray(b), jnp.asarray(X))
    vt, vj = vt.numpy(), np.asarray(vj)
    np.testing.assert_array_equal(vt, vj)
    close(Rt.numpy()[vt], np.asarray(Rj)[vj], rtol=1e-7, atol=1e-9)
    close(tt.numpy()[vt], np.asarray(tj)[vj], rtol=1e-7, atol=1e-9)
    # the true pose is among the candidates of every sample
    err = np.abs(Rt.numpy() - R[:, None]).max((-2, -1))
    assert (np.where(vt, err, np.inf).min(-1) < 1e-6).mean() >= 0.9
    P = rng.normal(size=(8, 6, 3))
    Q = np.einsum("ij,bnj->bni", R[0], P) + t[0]
    close(tres.kabsch(T(P), T(Q))[0], jres.kabsch(jnp.asarray(P), jnp.asarray(Q))[0])
    close(tres.bearing_angular_error(T(R[0]), T(t[0]), T(b[0]), T(X[0])),
          jres.bearing_angular_error(jnp.asarray(R[0]), jnp.asarray(t[0]), jnp.asarray(b[0]),
                                     jnp.asarray(X[0])), rtol=1e-6, atol=1e-20)


def test_find_rts():
    rng = np.random.default_rng(15)
    x = rng.normal(size=(2, 20, 3))
    R = np.asarray(jso3.expmap(jnp.asarray(rng.normal(size=(2, 3)))))
    y = 2.5 * np.einsum("bij,bnj->bni", R, x) + rng.normal(size=(2, 1, 3)) \
        + rng.normal(size=x.shape) * 1e-3
    st = tsim.find_rts(T(x), T(y))
    sj = jsim.find_rts(jnp.asarray(x), jnp.asarray(y))
    close(st.scale, sj.scale)
    close(st.R, sj.R)
    ref = np.asarray(sj.scale)[:, None, None] * np.einsum(
        "bij,bnj->bni", np.asarray(sj.R), x) + np.asarray(sj.t)[:, None]
    close(st.apply(T(x)), ref)


def test_linalg_helpers():
    """The cuSOLVER-free solvers against numpy's LAPACK."""
    rng = np.random.default_rng(16)
    A = rng.normal(size=(6, 10, 10))
    B = rng.normal(size=(6, 10, 3))
    close(tlin.solve(T(A), T(B)), np.linalg.solve(A, B), rtol=1e-8)
    S = A[:, :4, :4] @ A[:, :4, :4].transpose(0, 2, 1)
    w, V = tlin.eigh(T(S))
    wr, Vr = np.linalg.eigh(S)
    close(w, wr, rtol=1e-10)
    close(np.abs((V.numpy() * Vr).sum(-2)), np.ones((6, 4)), rtol=1e-9)
    M = rng.normal(size=(6, 3, 3))
    U, s, Vt = tlin.svd3(T(M))
    close(s, np.linalg.svd(M)[1], rtol=1e-10)
    close(U @ torch.diag_embed(s) @ Vt, M, rtol=1e-10, atol=1e-12)
