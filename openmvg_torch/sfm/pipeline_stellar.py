"""Stellar SfM engine: one local reconstruction ("pod") per pose, then
global averaging (counterpart: openmvg_tpu/sfm/pipeline_stellar.py; openMVG
sfm/pipelines/stellar, StellarSfMReconstructionEngine::Process,
sfm_stellar_engine.cpp:106).

  1. graph simplification: MST_X (default, X = 5 successive maximum
     spanning trees), STAR_X (each node's X best edges plus one tree) or
     NONE, inside the largest bi-edge-connected component
  2. the relative pose of every selected pair (batched AC-RANSAC, 5-point E)
  3. a pod per pose, the star of its edges (Stellar_Solver,
     stellar_solver.cpp:236-340): per-edge scales from 2-uplet ratios of
     median track depth to the centre pose, solved under L1 in the log
     domain; the pod's poses at those scales; its tracks seen in >= 3 of
     its views triangulated blind; a BA with intrinsics fixed; depth
     cleaning and the 4 px / 2 deg outlier filters; a second BA; the
     refined relative motions of its edges
  4. L2 rotation averaging over every pod motion
  5. SoftL1 translation averaging with one scale per pod
  6. the initial structure (tracks seen in >= 2 posed views), the global
     engine's staged BA, outlier removal and the final BA with the
     bad-track rejector loop.  No f64 polish, as in the reference.

The engine reuses the two other engines' steps; their configuration
records are read by attribute, so StellarConfig serves directly where its
fields carry the same meaning, and the pods' fixed settings are small
namespaces.  The 2-view triangulations of every relative pair are one
batched device call; each pod then measures its depths on the host.
Stage seconds go to utils.logging.stage_times.
"""

import dataclasses
import types
from typing import Dict, List, Tuple

import numpy as np
import torch

from openmvg_torch.ops import l1_admm
from openmvg_torch.ops import rotation_averaging as ra
from openmvg_torch.ops import translation_averaging as ta
from openmvg_torch.ops import triangulation as tri
from openmvg_torch.sfm import ba, filters
from openmvg_torch.sfm.pipeline_global import _staged_ba, compute_relative_poses
from openmvg_torch.sfm.pipeline_incremental import (GEOM_DTYPE, _bearings, _reconstruct_tracks,
                                                    _run_ba, _shared_track_corr, _TrackIndex)
from openmvg_torch.sfm.scene import Scene, rmse
from openmvg_torch.sfm.tracks import build_tracks
from openmvg_torch.utils import graph as graphlib
from openmvg_torch.utils.device import resolve_device
from openmvg_torch.utils.logging import stage


@dataclasses.dataclass
class StellarConfig:
    ransac_samples: int = 1024
    max_residual_px: float = 4.0
    ba_iterations: int = 30
    refine_intrinsics: object = ba.ADJUST_ALL
    min_track_views: int = 3
    verbose: bool = False
    dtype: object = torch.float32     # bundle adjustment on the device
    triangulation_angle_deg: float = 2.0
    # graph simplification (main_SfM.cpp:217-218 defaults)
    graph_simplification: str = "MST_X"   # MST_X | STAR_X | NONE
    graph_simplification_value: int = 5
    # Stellar_Solver settings
    min_uplet_tracks: int = 15        # EstimateTripletRelativeScale :152
    pod_ba_iterations: int = 12
    min_pod_poses: int = 3


def _log(cfg, *msg):
    if cfg.verbose:
        print("[stellar]", *msg, flush=True)


def _mst_pairs(matches, n_trees=1):
    """n_trees successive Kruskal spanning trees over -match count; an
    edge taken gets weight 0, so later trees prefer unused edges
    (selectMST, sfm_stellar_engine.cpp:191-234)."""
    pairs = list(matches)
    nodes = sorted({v for p in pairs for v in p})
    idx = {v: i for i, v in enumerate(nodes)}
    weight = {p: -len(matches[p]) for p in pairs}
    selected = set()
    for _ in range(n_trees):
        parent = list(range(len(nodes)))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for p in sorted(pairs, key=lambda q: weight[q]):
            ra_, rb = find(idx[p[0]]), find(idx[p[1]])
            if ra_ != rb:
                parent[ra_] = rb
                selected.add(p)
                weight[p] = 0
    return selected


def _simplify_graph(matches, cfg):
    method = cfg.graph_simplification.upper()
    if method == "NONE":
        return set(matches)
    if method == "MST_X":
        return _mst_pairs(matches, cfg.graph_simplification_value)
    # STAR_X: each node's X best edges by match count, and one tree for
    # connectivity (sfm_stellar_engine.cpp:267-308)
    selected = set()
    per_node: Dict[int, List[Tuple[int, int]]] = {}
    for p in matches:
        per_node.setdefault(p[0], []).append(p)
        per_node.setdefault(p[1], []).append(p)
    for edges in per_node.values():
        selected.update(sorted(edges, key=lambda p: -len(matches[p]))
                        [:cfg.graph_simplification_value])
    selected.update(_mst_pairs(matches, 1))
    return selected


def _pair_points(scene, index, rel, device):
    """The 2-view reconstruction of every relative pair at |t| = 1, in one
    bearings call and one triangulation call: {pair: (track_ids, X in the
    first view's frame, ok)} as numpy, for the pairs with >= 3 shared
    tracks (EstimateTripletRelativeScale's depth data,
    stellar_solver.cpp:126-215)."""
    recs = []
    for pair in rel:
        xa, xb, tids = _shared_track_corr(index, *pair)
        if len(tids) >= 3:
            recs.append((pair, xa, xb, tids))
    if not recs:
        return {}
    views = np.concatenate([np.r_[np.full(len(t), p[0]), np.full(len(t), p[1])]
                            for p, _, _, t in recs])
    b = _bearings(scene, views, np.concatenate([np.concatenate([xa, xb])
                                                for _, xa, xb, _ in recs]), device)
    b1, b2, Rs, ts, ofs = [], [], [], [], 0
    for pair, _, _, tids in recs:
        n = len(tids)
        b1.append(b[ofs:ofs + n])
        b2.append(b[ofs + n:ofs + 2 * n])
        Rs.append(np.broadcast_to(rel[pair]["R"], (n, 3, 3)))
        ts.append(np.broadcast_to(rel[pair]["t"], (n, 3)))
        ofs += 2 * n

    def d(parts):
        return torch.as_tensor(np.concatenate(parts), dtype=GEOM_DTYPE, device=device)

    n_all = ofs // 2
    X, ok = tri.triangulate_2view(
        torch.eye(3, dtype=GEOM_DTYPE, device=device).expand(n_all, 3, 3),
        torch.zeros((n_all, 3), dtype=GEOM_DTYPE, device=device), d(b1), d(Rs), d(ts), d(b2))
    X, ok = X.cpu().numpy(), ok.cpu().numpy()
    out, ofs = {}, 0
    for pair, _, _, tids in recs:
        n = len(tids)
        out[pair] = (tids, X[ofs:ofs + n], ok[ofs:ofs + n])
        ofs += n
    return out


def _edge_depth_map(pair_pts, rel, pair, center):
    """{track_id: distance to the centre pose's camera} in the 2-view
    reconstruction of `pair`."""
    if pair not in pair_pts:
        return {}
    track_ids, X, ok = pair_pts[pair]
    ok = ok & (np.linalg.norm(X, axis=1) < 1e4)
    R, t = rel[pair]["R"], rel[pair]["t"]
    C_center = np.zeros(3) if center == pair[0] else -R.T @ t
    dist = np.linalg.norm(X - C_center, axis=1)
    return dict(zip(track_ids[ok].tolist(), dist[ok]))


def _pod_scales_l1(depth_maps, edges, cfg, device="cpu"):
    """Per-edge |t| scales from the 2-uplet median-depth ratios, solved for
    log-scales under L1 (SCALING_SOLVER_L1, stellar_definitions.hpp:183)
    with the first edge pinned, normalised so the largest scale is 1."""
    edges_ok = [e for e in edges if depth_maps.get(e)]
    if len(edges_ok) < 2:
        return {}
    eidx = {e: i for i, e in enumerate(edges_ok)}
    rows, rhs = [], []
    for a in range(len(edges_ok)):
        for b in range(a + 1, len(edges_ok)):
            ea, eb = edges_ok[a], edges_ok[b]
            common = depth_maps[ea].keys() & depth_maps[eb].keys()
            if len(common) < cfg.min_uplet_tracks:
                continue
            med_a = np.median([depth_maps[ea][t] for t in common])
            med_b = np.median([depth_maps[eb][t] for t in common])
            if med_a <= 0 or med_b <= 0:
                continue
            rows.append((eidx[ea], eidx[eb]))
            rhs.append(np.log(med_a / med_b))
    n = len(edges_ok) - 1
    if not rows or n == 0:
        return {}
    # S_a - S_b = log(med_a / med_b), S_0 = 0 (the gauge)
    A = np.zeros((len(rows), n))
    for r, (ia, ib) in enumerate(rows):
        if ia != 0:
            A[r, ia - 1] = 1.0
        if ib != 0:
            A[r, ib - 1] = -1.0
    x = l1_admm.solve_lad(torch.as_tensor(A, device=device),
                          torch.as_tensor(np.asarray(rhs), device=device)).cpu().numpy()
    logs = np.concatenate([[0.0], x])
    scales = np.exp(logs - logs.max())
    return {e: float(scales[i]) for e, i in eidx.items()}


def _pod_sub_scene(scene, rel, edges, center, scales):
    """A scene with only the pod's poses: the centre at the identity, each
    neighbour from its relative pose at its scale (stellar_definitions.hpp
    :239-283)."""
    sub = Scene()
    sub.view_filename = list(scene.view_filename)
    sub.view_intrinsic = scene.view_intrinsic.copy()
    sub.view_pose = scene.view_pose.copy()
    sub.view_wh = scene.view_wh
    sub.cameras = scene.cameras
    sub.pose_valid = np.zeros(scene.n_poses, bool)
    sub.pose_R = np.tile(np.eye(3), (scene.n_poses, 1, 1))
    sub.pose_C = np.zeros((scene.n_poses, 3))

    def set_pose(v, R, C):
        pid = scene.view_pose[v]
        sub.pose_valid[pid] = True
        sub.pose_R[pid] = R
        sub.pose_C[pid] = C

    set_pose(center, np.eye(3), np.zeros(3))
    for e in edges:
        s = scales.get(e)
        if s is None or s <= 0:
            continue
        R, t = rel[e]["R"], rel[e]["t"]
        if e[0] == center:
            set_pose(e[1], R, (-R.T @ t) / s)
        else:     # e[0] seen from the centre e[1]: R' = R^T, C' = t
            set_pose(e[0], R.T, t / s)
    return sub


def _pod_reconstruction(scene, index, rel, pair_pts, edges, center, cfg, device):
    """Stellar_Solver::Solve and Optimize for one pod: the refined
    {pair: (R_ij, t_ij)} of its edges, or None."""
    depth_maps = {e: _edge_depth_map(pair_pts, rel, e, center) for e in edges}
    scales = _pod_scales_l1(depth_maps, edges, cfg, device)
    if len(scales) < 2:
        return None
    sub = _pod_sub_scene(scene, rel, edges, center, scales)
    if int(sub.pose_valid.sum()) < cfg.min_pod_poses:
        return None
    pod_views = {center}
    for e in scales:
        pod_views.update(e)
    posed_mask = np.zeros(scene.n_views, bool)
    posed_mask[list(pod_views)] = True
    rows_posed = posed_mask[index.tracks.view_id]
    cand = np.bincount(index.tracks.track_id[rows_posed], minlength=index.n_tracks)
    cand_tracks = np.nonzero(cand >= 3)[0]
    if len(cand_tracks) < cfg.min_uplet_tracks:
        return None
    lot = np.full(index.n_tracks, -1, np.int64)
    blind = types.SimpleNamespace(triangulation_angle_deg=0.0, max_residual_px=np.inf)
    _reconstruct_tracks(sub, index, cand_tracks, lot, blind, device)
    if sub.n_landmarks < cfg.min_uplet_tracks:
        return None
    # BA with the intrinsics fixed (Optimize :468-480), cleanup, second BA
    pod_ba = types.SimpleNamespace(refine_intrinsics=ba.ADJUST_NONE,
                                   ba_iterations=cfg.pod_ba_iterations, dtype=cfg.dtype)
    _run_ba(sub, pod_ba, device)
    filters.depth_cleaning(sub, 5.2, 12, 3)
    filters.remove_outliers_pixel_residual(sub, 4.0, 3)
    filters.remove_outliers_angle_error(sub, 2.0)
    filters.erase_unstable_poses_and_observations(sub, 12, 3)
    if int(sub.pose_valid.sum()) < cfg.min_pod_poses:
        return None
    _run_ba(sub, pod_ba, device)
    out = {}
    for e in scales:
        pa, pb = scene.view_pose[e[0]], scene.view_pose[e[1]]
        if not (sub.pose_valid[pa] and sub.pose_valid[pb]):
            continue
        Ri, Rj = sub.pose_R[pa], sub.pose_R[pb]
        R_ij = Rj @ Ri.T
        out[e] = (R_ij, -Rj @ sub.pose_C[pb] - R_ij @ (-Ri @ sub.pose_C[pa]))
    return out if len(out) >= 2 else None


def stellar_sfm(scene: Scene, features: List[np.ndarray],
                matches: Dict[Tuple[int, int], np.ndarray],
                cfg: StellarConfig = StellarConfig(), seed: int = 0, device=None, stats=None):
    """Run the stellar pipeline; mutates and returns `scene`.

    features[v]: (N_v, >= 2) feature positions of view v; matches[(i, j)]:
    (M, 2) feature index pairs.  device: None = cuda (raises without a
    card); pass "cpu" to run on the CPU.  stats, a dict if given, receives
    `pods` (the pods reconstructed), `rounds` (the final BA's runs: one
    plus one per rejector pass) and `polish_steps` (0: no polish)."""
    device = resolve_device(device)
    stats = {} if stats is None else stats
    stats.update(pods=0, rounds=0, polish_steps=0)
    tracks = build_tracks(matches, min_length=2)
    index = _TrackIndex(tracks, features)

    selected = _simplify_graph(matches, cfg)
    keep_nodes = graphlib.largest_biedge_connected_component(list(matches))
    pairs = sorted(p for p in selected if p[0] in keep_nodes and p[1] in keep_nodes)
    _log(cfg, f"graph simplification {cfg.graph_simplification}: "
              f"{len(pairs)}/{len(matches)} pairs")
    with stage("relative_poses"):
        rel = compute_relative_poses(scene, index, pairs, cfg, seed, device)
    if len(rel) < 3:
        raise RuntimeError("not enough relative poses")
    _log(cfg, f"{len(rel)} relative poses")

    pods: Dict[int, Dict[Tuple[int, int], tuple]] = {}
    with stage("pods"):
        pair_pts = _pair_points(scene, index, rel, device)
        for c in sorted({v for p in rel for v in p}):
            edges = [p for p in rel if c in p]
            if len(edges) < 2:
                continue
            motions = _pod_reconstruction(scene, index, rel, pair_pts, edges, c, cfg, device)
            if motions:
                pods[c] = motions
    if not pods:
        raise RuntimeError("no stellar pod could be reconstructed")
    stats["pods"] = len(pods)
    _log(cfg, f"{len(pods)} pods reconstructed")

    # rotation averaging over every pod motion in the largest component
    cc_nodes = max(graphlib.connected_components(list({e for m in pods.values() for e in m})),
                   key=len)
    views = sorted(cc_nodes)
    vmap_ = {v: i for i, v in enumerate(views)}
    with stage("rotation_averaging"):
        ei, ej, R_rel = [], [], []
        for motions in pods.values():
            for (a, b), (R_ab, _) in motions.items():
                if a in cc_nodes and b in cc_nodes:
                    ei.append(vmap_[a])
                    ej.append(vmap_[b])
                    R_rel.append(R_ab)
        R_glob = ra.l2_rotation_averaging(len(views), np.asarray(ei), np.asarray(ej),
                                          np.stack(R_rel), np.ones(len(ei)),
                                          device=device).cpu().numpy()

    # translation averaging, one scale per pod (its RelativeInfo_Vec group)
    with stage("translation_averaging"):
        tei, tej, tR, tt, group = [], [], [], [], []
        for g, ms in enumerate(pods.values()):
            for (a, b), (_, t_ab) in ms.items():
                if a not in cc_nodes or b not in cc_nodes:
                    continue
                i, j = vmap_[a], vmap_[b]
                tei.append(i)
                tej.append(j)
                tR.append(R_glob[j] @ R_glob[i].T)   # from the averaged rotations
                tt.append(t_ab)
                group.append(g)
        group = np.unique(np.asarray(group), return_inverse=True)[1]
        t_glob, _ = ta.solve_translation_averaging(
            len(views), np.asarray(tei), np.asarray(tej), np.stack(tR), np.stack(tt),
            method=ta.SOFTL1, scale_group=group, device=device)

    for v, i in vmap_.items():
        pid = scene.view_pose[v]
        scene.pose_valid[pid] = True
        scene.pose_R[pid] = R_glob[i]
        scene.pose_C[pid] = -R_glob[i].T @ t_glob[i]

    landmark_of_track = np.full(index.n_tracks, -1, np.int64)
    posed_mask = np.zeros(scene.n_views, bool)
    posed_mask[views] = True
    cand = np.bincount(index.tracks.track_id[posed_mask[index.tracks.view_id]],
                       minlength=index.n_tracks)
    tri_cfg = types.SimpleNamespace(triangulation_angle_deg=2.0,
                                    max_residual_px=cfg.max_residual_px)
    with stage("initial_structure"):
        _reconstruct_tracks(scene, index, np.nonzero(cand >= 2)[0], landmark_of_track, tri_cfg,
                            device)
    with stage("staged_ba"):
        _staged_ba(scene, cfg, device)
        filters.remove_outliers_pixel_residual(scene, cfg.max_residual_px, 2)
        filters.remove_outliers_angle_error(scene, 2.0)
        filters.erase_unstable_poses_and_observations(scene, 12, 3)
        _run_ba(scene, cfg, device)
        stats["rounds"] = 1
        while filters.bad_track_rejector(scene, cfg.max_residual_px, 50):
            _run_ba(scene, cfg, device)
            stats["rounds"] += 1
    if cfg.verbose:
        _log(cfg, f"done: {int(scene.pose_valid.sum())} poses, {scene.n_landmarks} "
                  f"landmarks, rmse={rmse(scene):.3f}")
    return scene
