"""Scaling harness over mesh prefixes (counterpart:
openmvg_tpu/parallel/scaling_bench.py): the same workload on meshes of the
first 1, 2, 4, ... ranks of the world, with throughput and efficiency
against linear scaling, or the overhead of the sharded run against one
rank doing the same work.

Every rank of the world calls these functions alike (SPMD); sizes beyond
the world are skipped.  The times are rank 0's, each ending at a barrier
of the mesh, so they include the slowest rank.  Ranks that share one card
(gloo, ranks beyond the cards) share its time and carry their collectives
through the host: their numbers measure the harness, not multi-card
scaling.
"""

import time

import numpy as np
import torch
import torch.distributed as dist

from openmvg_torch.parallel import mesh as meshlib


def _meshes(sizes):
    """{n: Mesh of the first n ranks} for the sizes within the world, in
    order (dist.new_group runs on every rank alike)."""
    world = dist.get_world_size()
    return {n: meshlib.make_mesh(n) for n in sizes if n <= world}


def _sync(mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    meshlib.barrier(mesh)


def _time(fn, reps, mesh):
    """Seconds a call of fn on the mesh's ranks (after one warm call);
    None on ranks outside the mesh."""
    if not mesh.member:
        return None
    fn()
    _sync(mesh)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(mesh)
    return (time.perf_counter() - t0) / reps


def _ba_step(problem, cfg, mesh, point_sharded):
    """A closure running one sharded LM step of `problem` on the mesh."""
    from openmvg_torch.parallel import dist_ba
    from openmvg_torch.sfm import ba

    if not mesh.member:
        return None
    if point_sharded:
        local, _ = dist_ba.local_point_shard(problem, mesh)
        step = dist_ba.make_point_sharded_lm_step(mesh, cfg)
    else:
        local = dist_ba.local_shard(dist_ba.pad_problem(problem, mesh.size), mesh, False)
        step = dist_ba.make_distributed_lm_step(mesh, cfg)
    local = ba.with_plans(local)
    lam = torch.as_tensor(cfg.lam_init, dtype=local.X.dtype, device=local.X.device)
    return lambda: step(local, lam)[2]


def measure_ba_scaling(problem, cfg, mesh_sizes=(1, 2, 4, 8), reps=3,
                       point_sharded=True):
    """Wall-clock one sharded LM step at each mesh size.  Returns {size:
    {"seconds", "throughput_obs_per_s", "efficiency"}} with efficiency =
    throughput(n) / (n throughput(first size) / first size)."""
    n_obs = int((problem.obs_w > 0).sum())
    results, base = {}, None
    for n, mesh in _meshes(mesh_sizes).items():
        run = _ba_step(problem, cfg, mesh, point_sharded)
        dt = _time(run, reps, mesh) if run is not None else None
        dist.barrier()
        if dist.get_rank() != 0:
            continue
        thr = n_obs / dt
        if base is None:
            base = thr / n
        results[n] = {"seconds": dt, "throughput_obs_per_s": thr,
                      "efficiency": thr / (n * base)}
    return results


def _overhead_stats(run_ref, run_n, trials):
    """Interleaved trials of (reference, sharded); the per-trial overhead
    t_n / t_ref - 1 as median, min and max, never clamped: a negative
    median is the measurement floor, and the spread says how far to trust
    it."""
    ovs, refs, ns = [], [], []
    for _ in range(trials):
        t_ref = run_ref()
        t_n = run_n()
        refs.append(t_ref)
        ns.append(t_n)
        ovs.append(t_n / t_ref - 1.0)
    ovs = sorted(ovs)
    med = ovs[len(ovs) // 2]
    return {
        "t_1dev_s": round(float(np.median(refs)), 3),
        "t_ndev_s": round(float(np.median(ns)), 3),
        "overhead_median": round(med, 4),
        "overhead_min": round(ovs[0], 4),
        "overhead_max": round(ovs[-1], 4),
        "trials": trials,
        "efficiency_proj": round(1.0 / (1.0 + med), 4),
    }


def _broadcast_time(t, dev):
    """Rank 0's seconds on every rank (the other ranks' own times differ)."""
    on = dev if dist.get_backend() == "nccl" else "cpu"
    v = torch.tensor([t if t is not None else 0.0], dtype=torch.float64, device=on)
    dist.broadcast(v, src=0)
    return float(v)


def measure_weak_scaling(n_feats=1024, pairs_per_device=64, mesh_sizes=(1, 2, 4, 8), reps=3,
                         trials=5, ba_obs_per_device=65_536, ba_points=8_192, ba_poses=64,
                         cg_iterations=5, strong=False, report=None):
    """Communication overhead of the sharded paths: n ranks' worth of work
    (a) on one rank with no collectives and (b) sharded over n ranks, both
    through the same code, overhead(n) = T_sharded / T_one - 1, and the
    projection 1 / (1 + overhead).

    Workloads: pair-sharded brute-force matching (descriptors whole on
    every rank, the pair list cut in contiguous shards, one K1 launch a
    rank) and point-sharded bundle adjustment (one LM step of
    big_ba_problem).  strong=True holds the total work at max(sizes) ranks'
    worth instead of growing it with n.  `report`, when given, is called
    with the growing result after each size.  Returns the result on every
    rank (rank 0's times)."""
    from openmvg_torch.ops import matching
    from openmvg_torch.sfm import ba
    from openmvg_torch.utils.synthetic import big_ba_problem

    rng = np.random.default_rng(0)
    out = {"diagnosis": "ranks that share a card share its time: overhead below is the "
                        "collective and partitioning cost of the sharded run against one "
                        "rank doing the same work, efficiency_proj = 1/(1+overhead) its "
                        "projection"}
    meshes = _meshes(mesh_sizes)
    dev = next(iter(meshes.values())).device
    n_views = 16
    descs = torch.as_tensor(rng.integers(0, 255, (n_views, n_feats, 128)).astype(np.float32))
    counts = torch.full((n_views,), n_feats, dtype=torch.int32)
    all_pairs = np.asarray([(i, j) for i in range(n_views) for j in range(i + 1, n_views)])
    d_dev, c_dev = descs.to(dev), counts.to(dev)

    def run_match(n_mesh, k):
        """Rank 0's seconds for k pairs matched over the first n_mesh ranks."""
        mesh = meshes[n_mesh]
        pairs = meshlib.pad_to_multiple(np.resize(all_pairs, (k, 2)).astype(np.int32), n_mesh)
        if mesh.member:
            local = meshlib.shard_rows(torch.as_tensor(pairs), mesh)
            t = _time(lambda: matching.match_pair_batch(d_dev, c_dev, local).mask, reps, mesh)
        else:
            t = None
        return _broadcast_time(t, dev)

    n_max = max(meshes)
    match_res = {}
    for n in meshes:
        k = pairs_per_device * (n_max if strong else n)
        if n == 1:
            t_ref = run_match(1, k)
            match_res[n] = {"pairs": k, "t_1dev_s": round(t_ref, 3),
                            "t_ndev_s": round(t_ref, 3), "overhead_median": 0.0,
                            "trials": 1, "efficiency_proj": 1.0}
        else:
            match_res[n] = dict(pairs=k, **_overhead_stats(
                lambda: run_match(1, k), lambda: run_match(n, k), trials))
        out["matching_pair_sharded"] = match_res
        if report is not None:
            report(out)

    ba_res = {}
    for n in meshes:
        opp = max(ba_obs_per_device // ba_points, 4)
        prob, O = big_ba_problem(n_poses=ba_poses, n_points=ba_points * (n_max if strong else n),
                                 obs_per_point=opp, seed=5)
        cfg = ba.BAConfig(cg_iterations=cg_iterations)

        def run_ba(n_mesh):
            mesh = meshes[n_mesh]
            step = _ba_step(prob, cfg, mesh, point_sharded=True)
            return _broadcast_time(_time(step, reps, mesh) if step is not None else None, dev)

        if n == 1:
            t_ref = run_ba(1)
            ba_res[n] = {"obs": O, "t_1dev_s": round(t_ref, 3), "t_ndev_s": round(t_ref, 3),
                         "overhead_median": 0.0, "trials": 1, "efficiency_proj": 1.0}
        else:
            ba_res[n] = dict(obs=O, **_overhead_stats(lambda: run_ba(1), lambda: run_ba(n),
                                                      trials))
        out["ba_point_sharded"] = ba_res
        if report is not None:
            report(out)
    return out


def measure_matching_scaling(n_views=8, n_feats=1024, mesh_sizes=(1, 2, 4, 8), reps=3):
    """Pair-sharded matching throughput at each mesh size.  Returns {size:
    {"seconds", "pairs_per_s", "efficiency"}} on rank 0, {} elsewhere."""
    from openmvg_torch.ops import matching

    rng = np.random.default_rng(0)
    descs = torch.as_tensor(rng.integers(0, 255, (n_views, n_feats, 128)).astype(np.float32))
    counts = torch.full((n_views,), n_feats, dtype=torch.int32)
    all_pairs = np.asarray([(i, j) for i in range(n_views) for j in range(i + 1, n_views)])
    results, base = {}, None
    for n, mesh in _meshes(mesh_sizes).items():
        k = len(all_pairs) // n * n
        dt = None
        if mesh.member:
            d, c = meshlib.whole(descs, mesh), meshlib.whole(counts, mesh)
            local = meshlib.shard_rows(torch.as_tensor(all_pairs[:k].astype(np.int32)), mesh)
            dt = _time(lambda: matching.match_pair_batch(d, c, local).mask, reps, mesh)
        dist.barrier()
        if dist.get_rank() != 0:
            continue
        thr = k / dt
        if base is None:
            base = thr / n
        results[n] = {"seconds": dt, "pairs_per_s": thr, "efficiency": thr / (n * base)}
    return results
