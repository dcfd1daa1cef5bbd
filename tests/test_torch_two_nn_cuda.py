"""Kernel K1 on the card: openmvg_torch/csrc/two_nn.cu against its plain
PyTorch version (openmvg_torch/ops/two_nn.py).  The kernel has no CPU
build, so every test here needs an NVIDIA card and nvcc and skips without
them.  On a machine with a card (which need not have JAX; the repo's
conftest imports it, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_two_nn_cuda.py -q

uint8 distances are exact integers on both sides, so d1, d2 and idx1 must
be bit-identical; float32 sums run in another order, so distances are held
to 1e-4 (1 + |d|) and indices must agree away from near-ties.
"""

import numpy as np
import pytest
import torch

from openmvg_torch.ops import matching, two_nn

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel K1 runs only there")
    return torch.device("cuda")


def _u8(rng, *shape):
    return rng.integers(0, 256, size=shape).astype(np.uint8)


def _assert_equal(got, ref):
    for x, y, what in zip(got, ref, ("d1", "d2", "idx1")):
        assert torch.equal(x.cpu(), y.cpu()), what


def _ragged_batch(seed):
    """Views with ragged counts, duplicated columns across tiles and
    rows of one view copied into another (exact ties and distance 0)."""
    rng = np.random.default_rng(seed)
    descs = _u8(rng, 4, 700, 128)
    descs[1, 7] = descs[1, 70] = descs[1, 650] = descs[0, 3]
    descs[2, :100] = descs[1, 100:200] ^ 1
    counts = np.array([700, 651, 130, 0], np.int32)
    pairs = np.array([[0, 1], [1, 0], [1, 2], [2, 3], [3, 1], [0, 0]], np.int32)
    return descs, counts, pairs


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_u8_exact_and_counted(dev, seed):
    descs, counts, pairs = (torch.as_tensor(x, device=dev) for x in _ragged_batch(seed))
    before = two_nn.LAUNCHES
    got = two_nn.two_nn_batch(descs, counts, pairs)
    torch.cuda.synchronize()
    assert two_nn.LAUNCHES == before + 1
    _assert_equal(got, two_nn.two_nn_batch_plain(descs, counts, pairs))
    assert got[2][0, 3].item() == 7 and got[0][0, 3].item() == 0  # lowest tied column


@pytest.mark.parametrize("frac_valid", [0.0, 0.3, 1.0])
def test_fused_u8_valid_b_exact(dev, frac_valid):
    rng = np.random.default_rng(2)
    a = torch.as_tensor(_u8(rng, 333, 128), device=dev)
    b = torch.as_tensor(_u8(rng, 517, 128), device=dev)
    b[200] = b[100] = a[5]
    vb = torch.as_tensor(rng.uniform(size=517) < frac_valid, device=dev)
    _assert_equal(two_nn.two_nn_fused(a, b, vb), two_nn.two_nn_plain(a, b, vb))


def test_ties_straddle_tensor_core_tiles(dev):
    """Equal B rows in one and in different 256-column tiles (7, 200, 900;
    255, 256, 511, 512), A rows copied from them, and duplicate A rows:
    the lowest tied column wins and d2 == d1 == 0."""
    rng = np.random.default_rng(5)
    a = _u8(rng, 300, 128)
    b = _u8(rng, 1000, 128)
    b[200] = b[900] = b[7]
    b[256] = b[511] = b[512] = b[255]
    a[0] = b[900]
    a[1] = b[512]
    a[129] = b[7]
    a[2:6] = a[2]
    a, b = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
    got = two_nn.two_nn_fused(a, b)
    _assert_equal(got, two_nn.two_nn_plain(a, b))
    assert [got[2][r].item() for r in (0, 1, 129)] == [7, 255, 7]
    assert got[0][0].item() == got[1][0].item() == 0


@pytest.mark.parametrize("n", [1, 127, 129, 3562])
def test_ragged_counts_exact(dev, n):
    """Counts on either side of the 128-row A tile and the 256-column B
    tile, in one batch with a full 3562-row view."""
    rng = np.random.default_rng(n)
    descs = torch.as_tensor(_u8(rng, 3, 3562, 128), device=dev)
    counts = torch.tensor([n, 3562, 129], dtype=torch.int32, device=dev)
    pairs = torch.tensor([[0, 1], [1, 0], [0, 0], [2, 0], [0, 2]], dtype=torch.int32,
                         device=dev)
    _assert_equal(two_nn.two_nn_batch(descs, counts, pairs),
                  two_nn.two_nn_batch_plain(descs, counts, pairs))


@pytest.mark.parametrize("D", [36, 64])
def test_short_descriptors_exact(dev, D):
    """D below 128 (4-byte copies when D % 16 != 0), zero-padded inside."""
    rng = np.random.default_rng(D)
    a = torch.as_tensor(_u8(rng, 200, D), device=dev)
    b = torch.as_tensor(_u8(rng, 300, D), device=dev)
    vb = torch.as_tensor(rng.uniform(size=300) < 0.7, device=dev)
    _assert_equal(two_nn.two_nn_fused(a, b, vb), two_nn.two_nn_plain(a, b, vb))


def test_pipeline_shaped_batch_exact(dev):
    """The matches stage's shape: 12 views of up to 3562 descriptors,
    CONTIGUOUS-6 pairs, one launch."""
    rng = np.random.default_rng(7)
    V = 12
    descs = torch.as_tensor(_u8(rng, V, 3562, 128), device=dev)
    counts = torch.as_tensor(rng.integers(2900, 3563, size=V).astype(np.int32), device=dev)
    pairs = torch.tensor([(i, j) for i in range(V) for j in range(i + 1, min(i + 7, V))],
                         dtype=torch.int32, device=dev)
    before = two_nn.LAUNCHES
    got = two_nn.two_nn_batch(descs, counts, pairs)
    torch.cuda.synchronize()
    assert two_nn.LAUNCHES == before + 1
    _assert_equal(got, two_nn.two_nn_batch_plain(descs, counts, pairs))


def test_fused_f32_within_tolerance(dev):
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.normal(size=(301, 96)).astype(np.float32), device=dev)
    b = torch.as_tensor(rng.normal(size=(450, 96)).astype(np.float32), device=dev)
    d1, d2, i1 = two_nn.two_nn_fused(a, b)
    r1, r2, ri = two_nn.two_nn_plain(a, b)
    assert ((d1 - r1).abs() <= 1e-4 * (1 + r1.abs())).all()
    assert ((d2 - r2).abs() <= 1e-4 * (1 + r2.abs())).all()
    near_tie = (r2 - r1) <= 2e-4 * (1 + r1)
    assert ((i1 == ri) | near_tie).all()


def test_match_pair_batch_card_equals_cpu(dev):
    descs, counts, pairs = _ragged_batch(4)
    cpu = matching.match_pair_batch(*(torch.as_tensor(x) for x in (descs, counts, pairs)))
    gpu = matching.match_pair_batch(*(torch.as_tensor(x, device=dev)
                                      for x in (descs, counts, pairs)))
    assert torch.equal(gpu.mask.cpu(), cpu.mask)
    assert torch.equal(gpu.idx_b.cpu()[cpu.mask], cpu.idx_b[cpu.mask])
    assert torch.equal(gpu.dist.cpu()[cpu.mask], cpu.dist[cpu.mask])


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    a = torch.zeros((8, 128), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        two_nn.two_nn_fused(a[:, ::2], a[:, ::2])
    with pytest.raises(TypeError):
        two_nn.two_nn_fused(a.to(torch.int32), a.to(torch.int32))
    with pytest.raises(ValueError, match="descriptor length"):
        two_nn.two_nn_fused(a[:, :6].contiguous(), a[:, :6].contiguous())
    with pytest.raises(ValueError, match="one CUDA device"):
        two_nn.two_nn_fused(a, a.cpu())
