"""Scene partitioning for sharded matching and bundle adjustment
(counterpart: openmvg_tpu/parallel/partitioner.py, the same functions and
the same outputs).

  * pair lists -> shards balanced by expected work (features_i *
    features_j), for pair-sharded matching
  * the BA observation table -> contiguous shards grouped by pose, with a
    report of how many poses and points live on one shard
"""

from typing import Dict, List, Tuple

import numpy as np


def partition_pairs(pairs: List[Tuple[int, int]], n_shards: int,
                    feature_counts=None) -> List[List[Tuple[int, int]]]:
    """Greedy balanced partition of a pair list by estimated match cost:
    pairs in decreasing cost, each to the least-loaded shard (ties to the
    lowest shard)."""
    if feature_counts is None:
        cost = {p: 1.0 for p in pairs}
    else:
        cost = {p: float(feature_counts[p[0]]) * float(feature_counts[p[1]])
                for p in pairs}
    order = sorted(pairs, key=lambda p: -cost[p])
    loads = np.zeros(n_shards)
    shards: List[List[Tuple[int, int]]] = [[] for _ in range(n_shards)]
    for p in order:
        k = int(np.argmin(loads))
        shards[k].append(p)
        loads[k] += cost[p]
    return shards


def partition_observations(obs_pose: np.ndarray, n_shards: int):
    """Observations sorted by pose (stable) and cut into n_shards equal
    runs, so a pose's observations sit on as few shards as possible.
    Returns (order, bounds): shard s owns order[bounds[s]:bounds[s + 1]]."""
    order = np.argsort(obs_pose, kind="stable")
    n = len(order)
    bounds = [0]
    per = -(-n // n_shards)
    for s in range(1, n_shards):
        bounds.append(min(s * per, n))
    bounds.append(n)
    return order, np.asarray(bounds)


def residency_report(obs_pose, obs_point, order, bounds) -> Dict:
    """Fraction of poses and of points whose observations all lie on one
    shard."""
    n_shards = len(bounds) - 1
    shard_of = np.empty(len(order), np.int32)
    for s in range(n_shards):
        shard_of[order[bounds[s]:bounds[s + 1]]] = s

    def single_shard_fraction(ids):
        out = {}
        for i, s in zip(ids, shard_of):
            out.setdefault(int(i), set()).add(int(s))
        single = sum(1 for v in out.values() if len(v) == 1)
        return single / max(len(out), 1)

    return dict(poses_single_shard=single_shard_fraction(obs_pose),
                points_single_shard=single_shard_fraction(obs_point))
