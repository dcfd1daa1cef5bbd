"""Kernel K2 (segment sum): the plain version against the JAX package's
seg_sum_mxu run in Pallas interpret mode and against the reference's own
ba._seg_sum, and the plan the kernel walks (the kernel itself, on a
card: tests/test_torch_seg_sum_cuda.py).

Tolerances: float64 sums agree to 1e-12 (1 + |ref|) with a float64
np.add.at; the Pallas kernel accumulates in float32, so it is held to
1e-5 (1 + |ref|) (measured: within 3.3e-6 at (9000, 36, 128)).
"""

import functools

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmvg_tpu.ops import pallas_segsum
from openmvg_tpu.sfm import ba as jba
from openmvg_torch.ops import seg_sum as k2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs on several workers at once, and
    small tensors gain nothing from more threads than the cores allow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(O, k, num, seed, out_of_range=0.1, dtype=np.float64):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(O, k)).astype(dtype)
    ids = rng.integers(0, max(num, 1), size=O)
    bad = rng.uniform(size=O) < out_of_range
    ids[bad] = rng.choice([-1, num, num + 7], size=int(bad.sum()))
    return vals, ids.astype(np.int32)


def _ref(vals, ids, num):
    out = np.zeros((num, vals.shape[1]))
    m = (ids >= 0) & (ids < num)
    np.add.at(out, ids[m], vals[m].astype(np.float64))
    return out


EDGE = [
    ("empty", 0, 6, 128),
    ("all_out_of_range", 500, 36, 128),
    ("one_segment_holds_all", 5000, 64, 1024),
    ("segments_without_rows", 300, 6, 1024),
    ("num_1", 2000, 8, 1),
    ("k36_num128", 9000, 36, 128),
    ("num_5000_beyond_1024", 20000, 12, 5000),
]


def _edge(name, O, k, num):
    vals, ids = _case(O, k, num, seed=O + k + num)
    if name == "all_out_of_range":
        ids[:] = num
    if name == "one_segment_holds_all":
        ids[:] = num - 1
    return vals, ids


@pytest.mark.parametrize("name,O,k,num", EDGE, ids=[e[0] for e in EDGE])
def test_plain_matches_float64_sum(name, O, k, num):
    vals, ids = _edge(name, O, k, num)
    got = k2.seg_sum(torch.as_tensor(vals), torch.as_tensor(ids), num)
    assert got.shape == (num, k) and got.dtype == torch.float64
    ref = _ref(vals, ids, num)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * (1 + np.abs(ref).max()))


@pytest.mark.parametrize("O,k,num", [(9000, 36, 128), (3000, 6, 100), (1500, 64, 3)])
def test_plain_matches_pallas_interpret(monkeypatch, O, k, num):
    """seg_sum_mxu imports pallas inside the function, so interpret mode
    is switched on from outside; nothing of the JAX package changes."""
    orig = jax.experimental.pallas.pallas_call
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        functools.partial(orig, interpret=True))
    vals, ids = _case(O, k, num, seed=3, dtype=np.float32)
    ref = np.asarray(pallas_segsum.seg_sum_mxu(jnp.asarray(vals), jnp.asarray(ids), num))
    got = k2.seg_sum(torch.as_tensor(vals), torch.as_tensor(ids), num).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * (1 + np.abs(ref).max()))


@pytest.mark.parametrize("num", [1, 128, 1024])
def test_plain_matches_reference_seg_sum(num):
    """The reference's _seg_sum on the CPU (its one-hot product path)."""
    vals, ids = _case(4000, 6, num, seed=num)
    ids = np.clip(ids, 0, num)  # the reference pads with `num`
    ref = np.asarray(jba._seg_sum(jnp.asarray(vals), jnp.asarray(ids), num))
    got = k2.seg_sum(torch.as_tensor(vals), torch.as_tensor(ids), num).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,O,k,num", EDGE, ids=[e[0] for e in EDGE])
def test_plan_covers_each_valid_row_once(name, O, k, num):
    """The plan the kernel walks, built on the CPU: its chunks partition
    each segment's valid rows, in row order, at most CHUNK rows each; the
    kernel's summation order over the plan reproduces the sums."""
    vals, ids = _edge(name, O, k, num)
    plan = k2.seg_sum_plan(torch.as_tensor(ids), num, chunk=700)
    perm = plan.perm.numpy()
    valid = np.nonzero((ids >= 0) & (ids < num))[0]
    assert sorted(perm.tolist()) == valid.tolist()
    start, end = plan.chunk_start.numpy(), plan.chunk_end.numpy()
    off = plan.seg_chunk_off.numpy()
    assert off[0] == 0 and off[-1] == len(start) and np.all(np.diff(off) >= 0)
    assert np.all(end - start <= 700) and np.all(end > start)
    out = np.zeros((num, k))
    for s in range(num):
        rows = np.concatenate([perm[a:b] for a, b in zip(start[off[s]:off[s + 1]],
                                                         end[off[s]:off[s + 1]])]
                              + [np.zeros(0, np.int64)])
        assert np.all(ids[rows] == s) and np.all(np.diff(rows) > 0)
        lanes = 256 // k          # pass 1: per-thread strided sums ...
        for a, b in zip(start[off[s]:off[s + 1]], end[off[s]:off[s + 1]]):
            lane_sums = [vals[perm[a + l:b:lanes]].sum(0) for l in range(lanes)]
            out[s] += np.sum(lane_sums, 0)   # ... lane sums, then chunk sums
    ref = _ref(vals, ids, num)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * (1 + np.abs(ref).max()))


def test_wrapper_refuses_unsupported_input():
    with pytest.raises(ValueError):
        k2.seg_sum(torch.zeros(4, 3), torch.zeros(5, dtype=torch.int32), 2)
    for num in (-1, 2 ** 31 // k2.MAX_K):
        with pytest.raises(ValueError):
            k2.seg_sum_plan(torch.zeros(4, dtype=torch.int32), num)
