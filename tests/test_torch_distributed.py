"""The port's sharded paths over 4 gloo ranks on the CPU, against the
port's single-process solve and openmvg_tpu's sharded solve on a mesh of 4
of the conftest's virtual CPU devices.

One spawn of 4 ranks (runtime.spawn, a FileStore under the test's
tmp_path, so concurrent test workers never share a port) runs every
sharded computation once; the tests then read its results:
observation- and point-sharded BA in float64 on the scenes of
tests/test_distributed.py (cost within 1e-6 relative, rotvec within 1e-8,
X within 1e-8 and 1e-7), ring matching and pair-sharded matching on uint8
(indices and masks equal), the scaling harness at sizes 1 and 2 with
the reference's keys, the hybrid grouping and replicate_to_global.  The
runtime's refusals (NCCL with more ranks than
cards, CUDA without a card) and spawn's (a failing rank, a timeout) are
checked without a card.
"""

import time

import numpy as np
import pytest
import torch

from openmvg_torch.parallel import runtime

N_RANKS = 4
SPAWN_TIMEOUT = 240


def _ba_inputs():
    """The reference's float64 problems of tests/test_distributed.py."""
    import jax.numpy as jnp

    from openmvg_tpu.sfm import ba as jba
    from openmvg_tpu.utils.synthetic import ring_scene
    from tests.test_ba import scene_from_ring
    from tests.test_torch_ba import fields_of

    out = {}
    for key, (n_points, seed) in (("obs", (60, 0)), ("point", (61, 2))):
        sc = scene_from_ring(ring_scene(n_views=8, n_points=n_points, seed=seed),
                             noise_X=0.02, seed=seed + 1)
        jp, _ = jba.problem_from_scene(sc, dtype=jnp.float64)
        out[key] = (jp, fields_of(jp))
    return out


def _planted(V, Nmax, lo, seed):
    """uint8 descriptors with correspondences planted against view 0."""
    rng = np.random.default_rng(seed)
    descs = rng.integers(0, 256, size=(V, Nmax, 128)).astype(np.uint8)
    counts = rng.integers(lo, Nmax + 1, size=V).astype(np.int32)
    for v in range(1, V):
        k = min(counts[0], counts[v])
        descs[v, :k] = descs[0, :k] + rng.integers(0, 3, (k, 128)).astype(np.uint8)
    return descs, counts


def _ranks(rank, n, inp):
    """Every sharded computation of the tests, on this rank."""
    from openmvg_torch.ops import matching
    from openmvg_torch.parallel import dist_ba, ring_matching, scaling_bench
    from openmvg_torch.parallel.mesh import all_gather_rows, make_mesh, shard_rows
    from openmvg_torch.sfm import ba

    mesh = make_mesh(n)
    out = {"launches": None}
    h = runtime.hybrid_mesh()
    out["hybrid"] = (h.shape, h.local.size, h.local.rank, h.across.size)
    x = torch.arange(8.0).reshape(4, 2)
    out["replicate"] = (runtime.replicate_to_global(x * (rank == 0), mesh).numpy(),
                        runtime.replicate_to_global(x, mesh, shard=True).numpy())
    cfg = ba.BAConfig(max_iterations=15)
    for key, fn in (("obs", dist_ba.adjust_distributed),
                    ("point", dist_ba.adjust_point_sharded)):
        p = ba.problem_from_reference(inp[key])
        q, cost = fn(p, mesh, cfg)
        out[key] = dict(cost=cost, X=q.X.numpy(), rotvec=q.rotvec.numpy())
    local, meta = dist_ba.local_point_shard(ba.problem_from_reference(inp["point"]), mesh)
    out["point_shard"] = dict(X_rows=local.X.shape[0], obs_rows=local.obs_pose.shape[0],
                              meta=meta)

    d, c = (torch.as_tensor(a) for a in inp["ring_all"])
    idx, mask, _ = ring_matching.ring_all_pairs_match(d, c, mesh)
    out["ring_all"] = [all_gather_rows(t.to(torch.int32), mesh).numpy() for t in (idx, mask)]
    d, c = (torch.as_tensor(a) for a in inp["ring_pairs"])
    res = ring_matching.ring_match_pairs(d, c, inp["ring_pairs_ij"], mesh)
    out["ring_pairs"] = None if res is None else (res.idx_b.numpy(), res.mask.numpy())

    d, c = (torch.as_tensor(a) for a in inp["sharded"])
    pairs = shard_rows(torch.as_tensor(inp["sharded_ij"]), mesh)
    res = matching.match_pair_batch(d, c, pairs)
    out["pair_sharded"] = [all_gather_rows(t.to(torch.int32), mesh).numpy()
                           for t in (res.idx_b, res.mask)]

    small = ba.problem_from_reference(inp["scaling"])
    out["ba_scaling"] = scaling_bench.measure_ba_scaling(
        small, ba.BAConfig(max_iterations=1, cg_iterations=8), mesh_sizes=(1, 2), reps=1)
    out["match_scaling"] = scaling_bench.measure_matching_scaling(
        n_views=5, n_feats=256, mesh_sizes=(1, 2), reps=1)
    out["weak"] = {strong: scaling_bench.measure_weak_scaling(
        n_feats=128, pairs_per_device=4, mesh_sizes=(1, 2), reps=1, trials=2,
        ba_obs_per_device=256, ba_points=64, ba_poses=8, cg_iterations=2, strong=strong)
        for strong in (False, True)}
    out["launches"] = runtime.kernel_launches()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs, the 4 ranks' results, and wall seconds of the spawn."""
    import jax.numpy as jnp

    from openmvg_tpu.sfm import ba as jba
    from openmvg_tpu.utils.synthetic import ring_scene
    from tests.test_ba import scene_from_ring
    from tests.test_torch_ba import fields_of

    ba_in = _ba_inputs()
    sc = scene_from_ring(ring_scene(n_views=6, n_points=48, seed=0), noise_X=0.01, seed=1)
    small, _ = jba.problem_from_scene(sc, dtype=jnp.float64)
    V, Nmax = 6, 128
    sh_d, sh_c = _planted(V, Nmax, 128, 7)
    sh_ij = np.asarray([(i, j) for i in range(V) for j in range(i + 1, V)], np.int32)[:8]
    ring_pairs = _planted(11, 64, 40, 5)   # 11 views: padded to 12 over 4 ranks
    inp = dict(obs=ba_in["obs"][1], point=ba_in["point"][1], scaling=fields_of(small),
               ring_all=_planted(8, 96, 60, 1), ring_pairs=ring_pairs,
               ring_pairs_ij=np.asarray([(i, j) for i in range(11) for j in range(i + 1, 11)]),
               sharded=(sh_d, sh_c), sharded_ij=sh_ij)
    t0 = time.perf_counter()
    res = runtime.spawn(_ranks, N_RANKS, device="cpu", backend="gloo", args=(inp,),
                        timeout=SPAWN_TIMEOUT, threads=1,
                        store=str(tmp_path_factory.mktemp("store")))
    return dict(inp=inp, ref=ba_in, res=res, secs=time.perf_counter() - t0)


def _reference_mesh():
    import jax

    from openmvg_tpu.parallel import mesh as jmesh

    assert len(jax.devices()) >= N_RANKS, "conftest forces 8 CPU devices"
    return jmesh.make_mesh(N_RANKS)


@pytest.mark.parametrize("mode,x_tol", [("obs", 1e-8), ("point", 1e-7)])
def test_sharded_ba_matches_single_and_reference(world, mode, x_tol):
    """Both sharded modes over 4 ranks: the port's single-process adjust
    and the reference's sharded solve on 4 devices reach the same cost
    (1e-6 relative), rotvec (1e-8) and X (1e-8 / 1e-7)."""
    from openmvg_tpu.parallel import dist_ba as jdist
    from openmvg_tpu.sfm import ba as jba
    from openmvg_torch.sfm import ba

    jp, fields = world["ref"][mode]
    cfg = ba.BAConfig(max_iterations=15)
    single, cost1, _ = ba.adjust(ba.problem_from_reference(fields), cfg)
    jfn = jdist.adjust_distributed if mode == "obs" else jdist.adjust_point_sharded
    jq, jcost = jfn(jp, _reference_mesh(), jba.BAConfig(max_iterations=15))
    L = fields["X"].shape[0]
    for r, got in enumerate(world["res"]):        # every rank holds the same result
        g = got[mode]
        for cost, X, rotvec in ((cost1, single.X.numpy(), single.rotvec.numpy()),
                                (jcost, np.asarray(jq.X)[:L], np.asarray(jq.rotvec))):
            assert abs(g["cost"] - cost) / max(cost, 1e-12) < 1e-6, (r, g["cost"], cost)
            np.testing.assert_allclose(g["rotvec"], rotvec, rtol=0, atol=1e-8)
            np.testing.assert_allclose(g["X"][:L], X, rtol=0, atol=x_tol)


def test_hybrid_mesh_and_replicate_to_global(world):
    """One node: the hybrid grouping is (1, 4); replicate_to_global
    broadcasts rank 0's value, or takes each rank's row."""
    x = np.arange(8.0).reshape(4, 2)
    for r, got in enumerate(world["res"]):
        assert got["hybrid"] == ((1, N_RANKS), N_RANKS, r, 1)
        whole, row = got["replicate"]
        np.testing.assert_array_equal(whole, x)
        np.testing.assert_array_equal(row, x[r:r + 1])


def test_point_shards_are_local(world):
    """Each rank holds only its point block and its observations."""
    for got in world["res"]:
        s = got["point_shard"]
        assert s["X_rows"] == s["meta"]["n_local"]
        assert s["obs_rows"] == s["meta"]["O_local"]
    assert world["res"][0]["point_shard"]["meta"]["n_shards"] == N_RANKS


def test_ring_all_pairs_match(world):
    """Ring-streamed all-pairs matching: every a < b block equals
    match_brute_force on the pair, and the skipped (b, a) half is empty."""
    from openmvg_torch.ops import matching

    descs, counts = world["inp"]["ring_all"]
    idx, mask = (a.astype(np.int64) for a in world["res"][0]["ring_all"])
    V, Nmax = descs.shape[:2]
    col = torch.arange(Nmax)
    for a in range(V):
        for b in range(V):
            if b <= a:
                assert not mask[a, b].any(), (a, b)
                continue
            ref = matching.match_brute_force(
                torch.as_tensor(descs[a]), torch.as_tensor(descs[b]),
                valid_a=col < int(counts[a]), valid_b=col < int(counts[b]))
            np.testing.assert_array_equal(mask[a, b], ref.mask.numpy(), err_msg=f"{a},{b}")
            np.testing.assert_array_equal(idx[a, b][mask[a, b] > 0],
                                          ref.idx_b.numpy()[ref.mask.numpy()])


def test_ring_match_pairs_equals_match_pair_batch_and_reference(world):
    """ring_match_pairs over 4 ranks (11 views padded to 12) equals
    match_pair_batch and the reference's ring_match_pairs on 4 devices:
    masks and matched indices equal; only rank 0 holds the result."""
    import jax.numpy as jnp

    from openmvg_tpu.parallel.ring_matching import ring_match_pairs as jring
    from openmvg_torch.ops import matching

    descs, counts = world["inp"]["ring_pairs"]
    pairs = world["inp"]["ring_pairs_ij"]
    idx_b, mask = world["res"][0]["ring_pairs"]
    assert all(r["ring_pairs"] is None for r in world["res"][1:])
    repl = matching.match_pair_batch(torch.as_tensor(descs), torch.as_tensor(counts),
                                     torch.as_tensor(pairs, dtype=torch.int32))
    np.testing.assert_array_equal(mask, repl.mask.numpy())
    np.testing.assert_array_equal(idx_b, repl.idx_b.numpy())
    ref = jring(jnp.asarray(descs), jnp.asarray(counts), jnp.asarray(pairs, jnp.int32),
                _reference_mesh())
    np.testing.assert_array_equal(mask, np.asarray(ref.mask))
    np.testing.assert_array_equal(idx_b[mask], np.asarray(ref.idx_b)[mask])


def test_pair_sharded_matching(world):
    """The pair list cut over 4 ranks, each matching its rows: the gathered
    result equals one match_pair_batch of the whole list."""
    from openmvg_torch.ops import matching

    d, c = world["inp"]["sharded"]
    pairs = world["inp"]["sharded_ij"]
    idx_b, mask = world["res"][0]["pair_sharded"]
    ref = matching.match_pair_batch(torch.as_tensor(d), torch.as_tensor(c),
                                    torch.as_tensor(pairs))
    np.testing.assert_array_equal(mask.astype(bool), ref.mask.numpy())
    np.testing.assert_array_equal(idx_b, ref.idx_b.numpy())
    assert ref.mask.numpy().any()


def test_scaling_harness_runs(world):
    """measure_ba_scaling and measure_matching_scaling at sizes 1 and 2 of
    a world of 4, with the reference's keys (results on rank 0)."""
    res = world["res"][0]
    rows = res["ba_scaling"]
    assert set(rows) == {1, 2}
    for row in rows.values():
        assert set(row) == {"seconds", "throughput_obs_per_s", "efficiency"}
        assert row["seconds"] > 0 and row["efficiency"] > 0
    assert rows[1]["efficiency"] == 1.0
    rows = res["match_scaling"]
    assert set(rows) == {1, 2} and rows[1]["efficiency"] == 1.0
    assert set(rows[2]) == {"seconds", "pairs_per_s", "efficiency"}
    assert world["res"][1]["ba_scaling"] == {}


@pytest.mark.parametrize("strong", [False, True])
def test_weak_and_strong_overhead_protocol(world, strong):
    """Interleaved trials report the median, min and max overhead, never
    clamped; strong scaling holds the total pair count fixed."""
    res = world["res"][0]["weak"][strong]
    for key in ("matching_pair_sharded", "ba_point_sharded"):
        rows = res[key]
        assert set(rows) == {1, 2}
        r2 = rows[2]
        assert r2["trials"] == 2
        assert {"overhead_median", "overhead_min", "overhead_max",
                "efficiency_proj"} <= set(r2)
        assert r2["overhead_min"] <= r2["overhead_median"] <= r2["overhead_max"]
    pairs = res["matching_pair_sharded"]
    assert pairs[2]["pairs"] == (pairs[1]["pairs"] if strong else 2 * pairs[1]["pairs"])


def test_spawn_within_its_timeout(world):
    assert world["secs"] < SPAWN_TIMEOUT
    assert all(r["launches"] == {"two_nn": 0, "seg_sum": 0, "smatvec": 0}
               for r in world["res"])      # the CPU takes the plain versions


def test_initialize_refuses_nccl_beyond_the_cards(monkeypatch, tmp_path):
    """Two ranks on a node with one card: NCCL cannot run, and initialize
    raises rather than pick gloo; naming NCCL on the CPU raises too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("OMT_DIST_BACKEND", raising=False)
    store = "file://" + str(tmp_path / "store")
    for backend in (None, "nccl"):
        with pytest.raises(RuntimeError, match="gloo"):
            runtime.initialize(store, 2, 0, backend=backend, device="cuda")
    with pytest.raises(ValueError, match="NCCL"):
        runtime.initialize(store, 2, 0, backend="nccl", device="cpu")
    with pytest.raises(RuntimeError, match="gloo"):
        runtime.spawn(_ranks, 2, device="cuda")
    assert not torch.distributed.is_initialized()


def test_initialize_refuses_cuda_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        runtime.initialize("file://" + str(tmp_path / "store"), 1, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        runtime.spawn(_ranks, 2, device="cuda", backend="gloo")
    assert not torch.distributed.is_initialized()


def _fail_on_rank_1(rank, n):
    if rank == 1:
        raise ValueError("rank 1 gives up")
    torch.distributed.barrier()      # rank 0 waits on its peer
    return rank


def _sleep(rank, n):
    time.sleep(120)


def test_spawn_raises_for_a_failed_rank_and_a_timeout(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        runtime.spawn(_fail_on_rank_1, 2, device="cpu", timeout=120, threads=1,
                      store=str(tmp_path / "a"))
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        runtime.spawn(_sleep, 2, device="cpu", timeout=10, threads=1,
                      store=str(tmp_path / "b"))
    assert time.perf_counter() - t0 < 60


def _world_info(rank, n):
    return rank, n, torch.distributed.get_backend()


def test_run_ranks_world_of_one_in_process():
    """One rank runs in this process, in a world of one left afterwards."""
    assert runtime.run_ranks(_world_info, 1, device="cpu") == [(0, 1, "gloo")]
    assert not torch.distributed.is_initialized()
