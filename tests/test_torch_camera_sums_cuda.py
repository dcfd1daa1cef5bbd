"""Kernel K2's fused camera sums on the card: camera_jtu and camera_jtj
(openmvg_torch/csrc/seg_sum.cu, omt_camera_sums_*) against their plain
versions (openmvg_torch/ops/seg_sum.py).  The kernel has no CPU build, so
every test here needs an NVIDIA card and nvcc and skips without them.  On a
machine with a card (which need not have JAX; the repo's conftest imports
it, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_camera_sums_cuda.py -q

The reference is the plain version on the same inputs in float64; the
kernel is held to tol (1 + S), S the sum of the magnitudes of the products
behind each output: 1e-5 in float32, 1e-12 in float64.  Each call is one
launch, and two launches on one input are bitwise equal (no float atomics).
"""

import numpy as np
import pytest
import torch

from openmvg_torch.ops import seg_sum as k2

pytestmark = pytest.mark.cuda


def camera_case(name, seed=0, O=3000, P=12, I=3):
    """Jacobian blocks, u and ids made with numpy:
    pose_without_rows  pose P // 2 has no row
    one_intrinsic      every row on intrinsic 0 of I = 1
    slack_slots        a fifth of the rows carry zero J (obs_w = 0 slots)
    out_of_range       a tenth of the ids are -1, num or num + 3
    all_out_of_range   every id is num
    final_ba           the main path's final bundle adjustment: 330,000
                       rows over 100 poses and one intrinsic
    """
    if name == "final_ba":
        O, P, I = 330000, 100, 1
    rng = np.random.default_rng(seed)
    Jp = rng.normal(size=(O, 2, 6))
    Ji = rng.normal(size=(O, 2, 8))
    u = rng.normal(size=(O, 2))
    pose = rng.integers(0, P, size=O)
    intr = rng.integers(0, I, size=O)
    if name == "pose_without_rows":
        pose[pose == P // 2] = P // 2 + 1
    elif name in ("one_intrinsic", "final_ba"):
        I = 1
        intr[:] = 0
    elif name == "slack_slots":
        slack = rng.uniform(size=O) < 0.2
        Jp[slack] = 0.0
        Ji[slack] = 0.0
        pose[slack] = 0
        intr[slack] = 0
    elif name == "out_of_range":
        for ids, num in ((pose, P), (intr, I)):
            bad = rng.uniform(size=O) < 0.1
            ids[bad] = rng.choice([-1, num, num + 3], size=int(bad.sum()))
    elif name == "all_out_of_range":
        pose[:] = P
        intr[:] = I
    return Jp, Ji, u, pose, intr, P, I


CASES = ["pose_without_rows", "one_intrinsic", "slack_slots", "out_of_range",
         "all_out_of_range", "no_rows", "final_ba"]


def _case(name, dtype, dev):
    Jp, Ji, u, pose, intr, P, I = camera_case(name, seed=CASES.index(name),
                                              **({"O": 0} if name == "no_rows" else {}))
    f = [torch.as_tensor(x.astype(dtype), device=dev) for x in (Jp, Ji, u)]
    i = [torch.as_tensor(x.astype(np.int32), device=dev) for x in (pose, intr)]
    return f, i, P, I


def _call(kind, f, i, P, I, plans=None):
    if kind == "jtu":
        return k2.camera_jtu(f[0], f[1], f[2], i[0], i[1], P, I, plans)
    return k2.camera_jtj(f[0], f[1], i[0], i[1], P, I, plans)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel K2 runs only there")
    k2.build()
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("kind", ["jtu", "jtj"])
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_repeats_one_launch(dev, dtype, tol, kind, name):
    f, i, P, I = _case(name, dtype, dev)
    plans = (k2.seg_sum_plan(i[0], P), k2.seg_sum_plan(i[1], I))
    before = k2.LAUNCHES
    got = _call(kind, f, i, P, I, plans)
    again = _call(kind, f, i, P, I, plans)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 2
    fc = [x.double().cpu() for x in f]
    ic = [x.cpu() for x in i]
    ref = _call(kind, fc, ic, P, I)
    mag = _call(kind, [x.abs() for x in fc], ic, P, I)
    for g, a, r, m in zip(got, again, ref, mag):
        assert g.shape == r.shape and g.dtype == f[0].dtype
        assert torch.equal(g, a)
        err = (g.cpu().double() - r).abs()
        assert bool((err <= tol * (1 + m)).all()), err.max().item()
        if kind == "jtj":
            assert torch.equal(g, g.transpose(-1, -2))
    assert not plans[0].counters.any() and not plans[1].counters.any()


def test_wrapper_raises_on_unsupported(dev):
    f, i, P, I = _case("one_intrinsic", np.float32, dev)
    with pytest.raises(TypeError):
        k2.camera_jtu(f[0].half(), f[1].half(), f[2].half(), i[0], i[1], P, I)
    with pytest.raises(ValueError, match="one dtype"):
        k2.camera_jtu(f[0], f[1].double(), f[2], i[0], i[1], P, I)
    with pytest.raises(ValueError, match="one device"):
        k2.camera_jtj(f[0], f[1], i[0].cpu(), i[1], P, I)
    off = torch.empty(f[0].numel() + 1, device=dev)[1:].view(f[0].shape)
    with pytest.raises(ValueError, match="16-byte"):
        k2.camera_jtj(off, f[1], i[0], i[1], P, I)
    with pytest.raises(ValueError, match="plan"):
        k2.camera_jtj(f[0], f[1], i[0], i[1], P, I, (k2.seg_sum_plan(i[0], P + 1), None))
    plan = k2.seg_sum_plan(i[0], P)
    with pytest.raises(ValueError, match="plans of their own"):
        k2.camera_jtu(f[0], f[1], f[2], i[0], i[0], P, P, (plan, plan))
