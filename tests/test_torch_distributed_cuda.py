"""The sharded paths on the card: 2 gloo ranks sharing cuda:0 (their
tensors and kernels on the card, gloo carrying the collectives through
host buffers).  Skips without a card.  On a machine with one (which need
not have JAX; the repo's conftest imports it, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_distributed_cuda.py -q

The point-sharded float64 solve, its camera and point sums on K2, equals
the single-rank solve on the card (cost within 1e-6 relative, rotvec
within 1e-8), every rank launching K2 and none K3; the ring matches each
block in one K1 launch (n - r blocks on rank r) and equals the plain
version on the CPU exactly (uint8).
"""

import numpy as np
import pytest
import torch

from openmvg_torch.parallel import runtime

pytestmark = pytest.mark.cuda

N = 2
PROBLEM = dict(n_poses=16, n_points=400, obs_per_point=6, seed=3, dtype=torch.float64)


def _descs():
    rng = np.random.default_rng(2)
    V, Nmax = 6, 256
    descs = rng.integers(0, 256, (V, Nmax, 128)).astype(np.uint8)
    counts = rng.integers(180, Nmax + 1, V).astype(np.int32)
    for v in range(1, V):
        k = min(counts[0], counts[v])
        descs[v, :k] = descs[0, :k] + rng.integers(0, 3, (k, 128)).astype(np.uint8)
    return descs, counts


def _ranks(rank, n):
    from openmvg_torch.ops import seg_sum, smatvec, two_nn
    from openmvg_torch.parallel import dist_ba, ring_matching
    from openmvg_torch.parallel.mesh import all_gather_rows, make_mesh
    from openmvg_torch.sfm import ba
    from openmvg_torch.utils.synthetic import big_ba_problem

    mesh = make_mesh(n)
    out = {}
    for m in (two_nn, seg_sum, smatvec):
        m.LAUNCHES = 0
    p, _ = big_ba_problem(**PROBLEM)
    q, cost = dist_ba.adjust_point_sharded(p, mesh, ba.BAConfig(max_iterations=10))
    out["ba"] = dict(cost=cost, rotvec=q.rotvec.numpy(), k2=seg_sum.LAUNCHES,
                     k3=smatvec.LAUNCHES)
    two_nn.LAUNCHES = 0
    d, c = (torch.as_tensor(a) for a in _descs())
    idx, mask, _ = ring_matching.ring_all_pairs_match(d, c, mesh)
    out["ring"] = dict(k1=two_nn.LAUNCHES, idx=all_gather_rows(idx, mesh).cpu().numpy(),
                       mask=all_gather_rows(mask.to(torch.int32), mesh).cpu().numpy())
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ranks' kernels K1 and K2 run only there")
    return runtime.spawn(_ranks, N, device="cuda", backend="gloo", timeout=240,
                         store=str(tmp_path_factory.mktemp("store")))


def test_point_sharded_ba_on_k2_equals_single(world):
    from openmvg_torch.sfm import ba
    from openmvg_torch.utils.synthetic import big_ba_problem

    p, _ = big_ba_problem(**PROBLEM, device="cuda")
    one, cost1, _ = ba.adjust(p, ba.BAConfig(max_iterations=10))
    for r in world:
        assert abs(r["ba"]["cost"] - cost1) / max(cost1, 1e-12) < 1e-6
        np.testing.assert_allclose(r["ba"]["rotvec"], one.rotvec.cpu().numpy(), rtol=0,
                                   atol=1e-8)
        assert r["ba"]["k2"] > 0 and r["ba"]["k3"] == 0


def test_ring_one_k1_launch_a_step(world):
    from openmvg_torch.ops import matching

    assert [r["ring"]["k1"] for r in world] == [N - r for r in range(N)]
    descs, counts = _descs()
    idx, mask = world[0]["ring"]["idx"], world[0]["ring"]["mask"].astype(bool)
    V, Nmax = descs.shape[:2]
    pairs = np.asarray([(a, b) for a in range(V) for b in range(a + 1, V)], np.int32)
    ref = matching.match_pair_batch(torch.as_tensor(descs), torch.as_tensor(counts),
                                    torch.as_tensor(pairs))
    for k, (a, b) in enumerate(pairs):
        np.testing.assert_array_equal(mask[a, b], ref.mask[k].numpy())
        np.testing.assert_array_equal(idx[a, b][mask[a, b]], ref.idx_b[k].numpy()[mask[a, b]])
