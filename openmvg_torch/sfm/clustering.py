"""Scene clustering into sub-reconstructions and match-graph splitting
(counterpart: openmvg_tpu/sfm/clustering.py).

Reference parity: software/SfM/clustering/main_ComputeClusters.cpp (split
a reconstruction into overlapping view clusters) and
sfm/sfm_data_graph_utils.cpp (split the match graph into connected
components of a minimum size; main_SplitMatchFileIntoMatchFiles).  The
k-means of cluster_views runs on the device through ops/vlad.kmeans,
whose Lloyd sums launch kernel K2 on the card.
"""

import copy
from typing import Dict, List, Set, Tuple

import numpy as np
import torch

from openmvg_torch.utils import graph as graphlib


def split_matches_by_component(matches: Dict[Tuple[int, int], np.ndarray],
                               min_nodes: int = 3) -> List[Dict[Tuple[int, int], np.ndarray]]:
    """The pair-match dict split by connected components of at least
    min_nodes views (SplitMatchesIntoClusterMatches)."""
    out = []
    for comp in graphlib.connected_components(list(matches)):
        if len(comp) < min_nodes:
            continue
        sub = {p: m for p, m in matches.items() if p[0] in comp and p[1] in comp}
        if sub:
            out.append(sub)
    return out


def cluster_views(scene, n_clusters: int, overlap_ratio: float = 0.1, seed: int = 0,
                  device="cuda") -> List[Set[int]]:
    """n_clusters spatially coherent groups of the posed views, with
    overlap (main_ComputeClusters.cpp's divide step): k-means of the
    camera centres (k-means++ seeding from a torch.Generator seeded
    `seed`), then each cluster takes its nearest outside views."""
    from openmvg_torch.ops.vlad import kmeans

    posed = scene.valid_view_poses().tolist()
    if not posed:
        return []
    C = scene.pose_C[scene.view_pose[posed]]
    n_clusters = min(n_clusters, len(posed))
    centers, assign = kmeans(torch.Generator().manual_seed(seed),
                             torch.as_tensor(C.astype(np.float32), device=device), n_clusters)
    centers, assign = centers.cpu().numpy(), assign.cpu().numpy()
    clusters = [set(np.asarray(posed)[assign == k].tolist()) for k in range(n_clusters)]
    n_extra = max(1, int(overlap_ratio * len(posed) / max(n_clusters, 1)))
    for k in range(n_clusters):
        outside = [v for v in posed if v not in clusters[k]]
        if not outside:
            continue
        d = np.linalg.norm(scene.pose_C[scene.view_pose[outside]] - centers[k], axis=1)
        for idx in np.argsort(d)[:n_extra]:
            clusters[k].add(int(outside[idx]))
    return [c for c in clusters if c]


def scene_for_views(scene, views: Set[int]):
    """The sub-scene of the given views: other observations invalidated,
    the poses of other views dropped, tracks shorter than 2 removed."""
    from openmvg_torch.sfm.filters import _drop_short_tracks

    sub = copy.deepcopy(scene)
    keep_view = np.zeros(scene.n_views, bool)
    keep_view[list(views)] = True
    sub.obs_valid = scene.obs_valid & keep_view[scene.obs_view]
    for v in range(scene.n_views):
        if not keep_view[v] and scene.view_pose[v] >= 0:
            sub.pose_valid[scene.view_pose[v]] = False
    _drop_short_tracks(sub, 2)
    return sub
