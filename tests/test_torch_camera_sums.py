"""Kernel K2's fused camera sums (openmvg_torch/ops/seg_sum.py: camera_jtu,
camera_jtj): their plain versions against the JAX package's
_camera_rmatvec and _block_outer_seg, and the bundle adjuster's CPU path
against the sequence it ran before the fusion (the kernel itself, on a
card: tests/test_torch_camera_sums_cuda.py, which also makes the cases).

Tolerance: float64 on both sides, |port - reference| <= 1e-12 (1 + S), S
the sum of the magnitudes of the products behind each output (the same
sums on |J| and |u|): the reference adds through one-hot matrix products,
the port in row order, and the rounding of a sum scales with what it adds.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmvg_tpu.models import cameras as jcm
from openmvg_tpu.sfm import ba as jba
from openmvg_torch.ops import seg_sum as k2
from openmvg_torch.sfm import ba as tba
from tests.test_torch_ba import _problem
from tests.test_torch_camera_sums_cuda import camera_case

TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs on several workers at once, and
    small tensors gain nothing from more threads than the cores allow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = ["pose_without_rows", "one_intrinsic", "slack_slots", "out_of_range"]


def _port(kind, Jp, Ji, u, pose, intr, P, I):
    t = [torch.as_tensor(x) for x in (Jp, Ji, u, pose, intr)]
    if kind == "jtu":
        return k2.camera_jtu(*t, P, I)
    return k2.camera_jtj(t[0], t[1], t[3], t[4], P, I)


def _reference(kind, Jp, Ji, u, pose, intr, P, I):
    j = [jnp.asarray(x) for x in (Jp, Ji, u)]
    jpose, jintr = jnp.asarray(pose, jnp.int32), jnp.asarray(intr, jnp.int32)
    if kind == "jtu":
        p = types.SimpleNamespace(obs_pose=jpose, obs_intr=jintr)
        return jba._camera_rmatvec(j[2], p, j[0], j[1], P, I)
    return jba._block_outer_seg(j[0], jpose, P), jba._block_outer_seg(j[1], jintr, I)


@pytest.mark.parametrize("kind", ["jtu", "jtj"])
@pytest.mark.parametrize("name", CASES)
def test_plain_matches_reference(kind, name):
    Jp, Ji, u, pose, intr, P, I = camera_case(name, seed=CASES.index(name))
    got = _port(kind, Jp, Ji, u, pose, intr, P, I)
    ref = _reference(kind, Jp, Ji, u, pose, intr, P, I)
    mag = _port(kind, np.abs(Jp), np.abs(Ji), np.abs(u), pose, intr, P, I)
    shapes = [(P, 6), (I, 8)] if kind == "jtu" else [(P, 6, 6), (I, 8, 8)]
    for g, r, m, shape in zip(got, ref, mag, shapes):
        assert g.shape == shape and g.dtype == torch.float64
        err = np.abs(g.numpy() - np.asarray(r))
        assert np.all(err <= TOL * (1 + m.numpy())), err.max()
    if name == "pose_without_rows":
        assert not got[0][P // 2].any()
    if kind == "jtj":  # symmetric bit for bit
        for g in got:
            assert torch.equal(g, g.transpose(-1, -2))


def test_wrapper_refuses_what_it_does_not_take():
    Jp, Ji, u, pose, intr, P, I = (torch.as_tensor(x) if isinstance(x, np.ndarray) else x
                                   for x in camera_case("one_intrinsic", O=50))
    with pytest.raises(ValueError, match="shapes"):
        k2.camera_jtu(Jp[:, :, :5], Ji, u, pose, intr, P, I)
    with pytest.raises(ValueError, match="shapes"):
        k2.camera_jtj(Jp, Ji, pose[:-1], intr, P, I)
    with pytest.raises(ValueError, match="one device"):
        k2.camera_jtu(Jp, Ji, u.to("meta"), pose, intr, P, I)


def _old_sequence(monkeypatch):
    """The bundle adjuster's camera sums as they ran before the fusion: the
    products formed first, then one generic K2 sum per half."""
    def rmatvec(u, p, Jp6, Ji8, n_pose, n_intr):
        return (tba._seg_sum(tba._brmatvec(Jp6, u), p.obs_pose, n_pose),
                tba._seg_sum(tba._brmatvec(Ji8, u), p.obs_intr, n_intr))

    def jtj(p, Jp6, Ji8, n_pose, n_intr):
        return (tba._seg_sum(tba._outer_flat(Jp6), p.obs_pose, n_pose).reshape(n_pose, 6, 6),
                tba._seg_sum(tba._outer_flat(Ji8), p.obs_intr, n_intr).reshape(n_intr, 8, 8))

    monkeypatch.setattr(tba, "_camera_rmatvec", rmatvec)
    monkeypatch.setattr(tba, "_camera_jtj", jtj)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_schur_cg_solve_bitwise_as_before(monkeypatch, dtype):
    """ba.py's CPU path gives the same damped solve as before, bit for bit."""
    _, tp = _problem(jcm.PINHOLE, (), 3)
    tp = tp._replace(**{f: getattr(tp, f).to(dtype) for f in tp._fields[3:16]
                        if getattr(tp, f).is_floating_point()})
    cfg = tba.BAConfig()
    r, Jp6, Ji8, Jx3 = tba.jacobians(tp, cfg, tba.cam_fast_ok(tp))
    lam = torch.tensor(1e-3, dtype=dtype)
    new = tba.schur_cg_solve(tp, r, Jp6, Ji8, Jx3, lam, cfg)
    with monkeypatch.context() as m:
        _old_sequence(m)
        old = tba.schur_cg_solve(tp, r, Jp6, Ji8, Jx3, lam, cfg)
    for a, b in zip(new, old):
        assert a.dtype == dtype and torch.equal(a, b)
