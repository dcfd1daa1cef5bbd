"""The frozen bound functions agree with the originals (chip_smoke.py)
and with the bounds PERF.md records at the main path's shapes."""

import importlib.util
import os

import pytest
import torch

from benchmark import bounds

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_bounds",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind,want", [("jtu", 0.0126), ("jtj", 0.0118)])
def test_camera_bound_at_the_final_incremental_ba(kind, want):
    # PERF.md's kernel table: O 330,064, P 100, I 1, float32
    assert bounds.camera_bound_ms(330064, 100, 1, kind, 4) == pytest.approx(want, abs=5e-5)


@pytest.mark.parametrize("k,want", [(6, 0.0028), (36, 0.0146)])
def test_seg_sum_bound_at_the_final_incremental_ba(k, want):
    assert bounds.seg_sum_bound_ms(330064, k, 100, 4) == pytest.approx(want, abs=5e-5)


@pytest.mark.parametrize("O,k,num,itemsize", [(330064, 6, 100, 4), (1255268, 36, 356, 4),
                                              (5000, 64, 2000, 8), (10, 1, 3, 4)])
def test_seg_sum_bound_equals_the_original(smoke, O, k, num, itemsize):
    assert bounds.seg_sum_bound_ms(O, k, num, itemsize) == smoke.seg_sum_bound_ms(
        O, k, num, itemsize)[0]


@pytest.mark.parametrize("O,P,I,kind", [(330064, 100, 1, "jtu"), (1255268, 356, 356, "jtj"),
                                        (2667, 1, 1, "jtu")])
def test_camera_bound_equals_the_original(smoke, O, P, I, kind):
    assert bounds.camera_bound_ms(O, P, I, kind, 4) == smoke.camera_bound_ms(O, P, I, kind,
                                                                              4)[0]


def test_smatvec_bound_equals_the_original(smoke):
    args = (354256, 60000, 45000, 4, 100, 1)
    assert bounds.smatvec_bound_ms(*args) == smoke.smatvec_bound_ms(*args)[0]


@pytest.mark.parametrize("int8", [True, False])
def test_two_nn_bound_equals_the_original(smoke, int8):
    g = torch.Generator().manual_seed(0)
    V, N, D = 6, 300, 128
    descs = torch.zeros((V, N, D), dtype=torch.uint8 if int8 else torch.float32)
    counts = torch.randint(50, N, (V,), generator=g, dtype=torch.int32)
    pairs = torch.tensor([[i, j] for i in range(V) for j in range(i + 1, V)], dtype=torch.int32)
    na = counts.long()[pairs[:, 0].long()]
    nb = counts.long()[pairs[:, 1].long()]
    want = smoke.two_nn_bound_ms(descs, counts, pairs, pairs.shape[0] * N, int8)[0]
    got = bounds.two_nn_bound_ms(float((na * nb).sum()), D, descs.numel() * descs.element_size(),
                                 V, pairs.shape[0], pairs.shape[0] * N, int8)
    assert got == pytest.approx(want, rel=1e-12)


def test_two_nn_headline_bound_by_hand():
    # 16 pairs of 4,096 x 4,096 uint8 descriptors of 128: operations bound it
    ops = 2 * 16 * 4096 * 4096 * 128
    got = bounds.two_nn_bound_ms(16 * 4096 * 4096, 128, 32 * 4096 * 128, 32, 16, 16 * 4096)
    assert got == pytest.approx(ops / 1979e12 * 1e3, rel=1e-12)
