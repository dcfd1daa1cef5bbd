"""Kernel K2 on the card: openmvg_torch/csrc/seg_sum.cu against its plain
PyTorch version (openmvg_torch/ops/seg_sum.py).  The kernel has no CPU
build, so every test here needs an NVIDIA card and nvcc and skips without
them.  On a machine with a card (which need not have JAX; the repo's
conftest imports it, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_seg_sum_cuda.py -q

The reference is the plain version on the same inputs in float64.  A
sum's rounding scales with the magnitudes it adds, not with the result
(which cancels: 45,000 float32 rows in one segment round to ~1e-3 where
their sum is near 0), so the kernel is held to tol (1 + S), S the
segment's sum of |values|: 1e-5 in float32, 1e-12 in float64.  A call is
one launch, and two launches on one input must be bitwise equal (the
kernel uses no float atomics).
"""

import numpy as np
import pytest
import torch

from openmvg_torch.ops import seg_sum as k2

pytestmark = pytest.mark.cuda

CASES = [
    ("empty", 0, 6, 128, None),
    ("all_out_of_range", 500, 36, 128, "out"),
    ("one_segment_holds_all", 5000, 64, 1024, "one"),
    ("segments_without_rows", 300, 6, 1024, None),
    ("num_1", 2000, 8, 1, None),
    ("k36_num128", 9000, 36, 128, None),
    ("k6_num128_large", 200000, 6, 128, None),
    ("k9_num50000_beyond_1024", 200000, 9, 50000, None),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel K2 runs only there")
    k2.build()
    return torch.device("cuda")


def _case(O, k, num, kind, seed, dtype):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(O, k)).astype(dtype)
    ids = rng.integers(0, num, size=O)
    bad = rng.uniform(size=O) < 0.1
    ids[bad] = rng.choice([-1, num, num + 7], size=int(bad.sum()))
    if kind == "out":
        ids[:] = num
    elif kind == "one":
        ids[:] = num - 1
    return vals, ids.astype(np.int32)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("name,O,k,num,kind", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain_and_repeats(dev, dtype, tol, name, O, k, num, kind):
    vals, ids = _case(O, k, num, kind, O + k + num, dtype)
    v = torch.as_tensor(vals, device=dev)
    i = torch.as_tensor(ids, device=dev)
    plan = k2.seg_sum_plan(i, num)
    before = k2.LAUNCHES
    got = k2.seg_sum(v, i, num)
    again = k2.seg_sum(v, i, num, plan)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 2  # one launch a call
    assert not plan.counters.any()    # each launch leaves its counters at 0
    assert torch.equal(got, again)
    vd = v.double().cpu()
    ref = k2.seg_sum_plain(vd, i.cpu(), num)
    scale = k2.seg_sum_plain(vd.abs(), i.cpu(), num)
    err = (got.cpu().double() - ref).abs()
    assert bool((err <= tol * (1 + scale)).all())


def test_wrapper_raises_on_unsupported(dev):
    with pytest.raises(TypeError):
        k2.seg_sum(torch.zeros((4, 3), dtype=torch.float16, device=dev),
                   torch.zeros(4, dtype=torch.int32, device=dev), 2)
    with pytest.raises(ValueError):
        k2.seg_sum(torch.zeros((4, 65), device=dev), torch.zeros(4, dtype=torch.int32,
                                                                 device=dev), 2)
