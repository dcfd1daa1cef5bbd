"""Global SfM engine: rotation and translation averaging, then staged
bundle adjustment (counterpart: openmvg_tpu/sfm/pipeline_global.py;
openMVG GlobalSfMReconstructionEngine_RelativeMotions::Process,
sfm_global_engine_relative_motions.cpp:112-175).

  1. keep the largest bi-edge-connected component of the pair graph
  2. relative pose of every pair (batched AC-RANSAC, 5-point E)
  3. triplet rotation rejection, then rotation averaging (L2 | L1)
  4. translation averaging (SOFTL1 default; L2-chordal; L1 by IRLS) of
     per-triplet relative translations (edge coverage,
     GlobalSfM_translation_averaging.cpp:440-637), one scale per triplet;
     two-view translations when triplets do not cover every view
  5. initial structure from the triplet-validated tracks seen in >= 3
     posed views
  6. staged BA T+X -> RT+X -> KRT+X, outlier removal (4 px, 2 deg),
     unstable-pose erasure (12 points a pose, 3 a landmark), final BA and
     the bad-track rejector loop, then the f64 polish

Geometry runs in float64 on the device (GEOM_DTYPE), the bundle adjuster
in GlobalConfig.dtype (float32).  Every candidate triplet's AC-RANSAC
verdict is computed up front in batches, triplet t drawing from its own
generator (seed, TRIPLET_STREAM + t), so the greedy edge coverage on the
host reads the same verdicts whatever the batching.  Stage seconds sum
into utils.logging.stage_times under the reference's names.
"""

import dataclasses
import types
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

from openmvg_torch.models import cameras as cm
from openmvg_torch.ops import ransac
from openmvg_torch.ops import rotation_averaging as ra
from openmvg_torch.ops import translation_averaging as ta
from openmvg_torch.ops import triplet_translation as tt
from openmvg_torch.sfm import ba, filters
from openmvg_torch.sfm.geometric_filter import pair_generator
from openmvg_torch.sfm.pipeline_incremental import (GEOM_DTYPE, _TrackIndex, _bearings,
                                                    _reconstruct_tracks, _run_ba,
                                                    relative_pose_batch)
from openmvg_torch.sfm.polish import f64_polish
from openmvg_torch.sfm.scene import Scene, rmse
from openmvg_torch.sfm.tracks import build_tracks
from openmvg_torch.utils import deadline
from openmvg_torch.utils import graph as graphlib
from openmvg_torch.utils.device import resolve_device
from openmvg_torch.utils.logging import stage

ROTATION_AVERAGING_L1 = 1
ROTATION_AVERAGING_L2 = 2          # reference default (main_SfM.cpp)
TRANSLATION_AVERAGING_L1 = 1
TRANSLATION_AVERAGING_L2_CHORDAL = 2
TRANSLATION_AVERAGING_SOFTL1 = 3   # reference default

TRIPLET_STREAM = 0x7121 << 16      # generator positions of the triplets
_TRIPLET_BATCH_ELEMENTS = 1 << 25  # (triplets x draws x tracks) per batch


@dataclasses.dataclass
class GlobalConfig:
    rotation_averaging: int = ROTATION_AVERAGING_L2
    translation_averaging: int = TRANSLATION_AVERAGING_SOFTL1
    ransac_samples: int = 1024
    triplet_max_angle_deg: float = 5.0
    max_residual_px: float = 4.0
    min_track_views: int = 3
    ba_iterations: int = 30
    refine_intrinsics: object = ba.ADJUST_ALL
    verbose: bool = False
    dtype: object = torch.float32     # bundle adjustment on the device
    f64_polish: bool = True
    # per-triplet translation estimation (edge coverage); two-view
    # translations when it leaves a view uncovered
    triplet_translation: bool = True
    triplet_min_tracks: int = 30      # Estimate_T_triplet: tracks.size() < 30
    triplet_min_inliers: int = 30     # bTest: vec_inliers.size() > 30
    triplet_samples: int = 320        # ORSA_ITER


def _log(cfg, *msg):
    if cfg.verbose:
        print("[global]", *msg, flush=True)


def compute_relative_poses(scene, index, pairs, cfg, seed, device):
    """Relative_Pose_Engine: robust two-view pose of every pair, batched.
    Returns {(i, j): dict(R, t, n_inliers, inlier_tracks)} in pair order."""
    infos = relative_pose_batch(scene, index, list(pairs), seed, device,
                                n_samples=cfg.ransac_samples)
    return {pair: dict(R=r["R"], t=r["t"], n_inliers=r["n_inliers"],
                       inlier_tracks=r["track_ids"][r["inliers"]])
            for pair, r in infos.items()}


def _shared_track_corr3(index, va, vb, vc):
    """Pixel coordinates (xa, xb, xc) and ids of the tracks seen in all
    three views."""
    ra_, rb, rc = (index.rows_of_view(v) for v in (va, vb, vc))
    tid = index.tracks.track_id
    cab, ia, ib = np.intersect1d(tid[ra_], tid[rb], return_indices=True)
    common, iab, ic = np.intersect1d(cab, tid[rc], return_indices=True)
    return (index.obs_xy[ra_[ia[iab]]], index.obs_xy[rb[ib[iab]]],
            index.obs_xy[rc[ic]], common)


def _evaluate_triplets_batched(scene, triplets, tri_data, R_of_view, cfg, seed, device):
    """The AC-RANSAC verdict of every candidate triplet, in batches.

    A verdict does not depend on the edge coverage, so all are computed
    up front and the greedy loop stays host logic with the reference's
    outcomes.  Normalised coordinates of every observation come from one
    bearings call; batches hold triplets of similar track counts, bounded
    by the size of their (triplets, draws, tracks) tables.  Triplet t draws
    its own (draws, n) Gumbel table from generator (seed, TRIPLET_STREAM + t),
    so its verdict does not depend on the batch it lands in.

    Returns {t_idx: (found, ts (3, 3), inliers (n,))}."""
    if not tri_data:
        return {}
    order = sorted(tri_data)
    views = np.concatenate([np.full(len(tri_data[t][3]), v, np.int64)
                            for t in order for v in triplets[t]])
    xy = np.concatenate([np.asarray(x, np.float64) for t in order for x in tri_data[t][:3]])
    b = _bearings(scene, views, xy, device)
    norm = b[:, :2] / b[:, 2:3]
    K_all = cm.K_matrix_np(np.asarray(scene.cameras.params, np.float64))
    focal = {v: K_all[scene.view_intrinsic[v]][0, 0] for t in order for v in triplets[t]}
    xs_of, off = {}, 0
    for t in order:
        n = len(tri_data[t][3])
        xs_of[t] = norm[off:off + 3 * n].reshape(3, n, 2)
        off += 3 * n

    S = int(cfg.triplet_samples)
    s1 = max(S * 9 // 10, 1)
    n_draws = s1 + max(S - s1, 1)
    by_size = sorted(order, key=lambda t: len(tri_data[t][3]))
    batches, cur = [], []
    for t in by_size:  # ascending: t is the widest of cur + [t]
        if cur and (len(cur) + 1) * n_draws * len(tri_data[t][3]) > _TRIPLET_BATCH_ELEMENTS:
            batches.append(cur)
            cur = []
        cur.append(t)
    if cur:
        batches.append(cur)

    results = {}
    for grp in batches:
        P, K = len(grp), len(tri_data[grp[-1]][3])
        xs = np.zeros((P, 3, K, 2))
        Rs = np.zeros((P, 3, 3, 3))
        valid = np.zeros((P, K), bool)
        prec = np.zeros(P)
        gumbel = torch.full((P, n_draws, K), -float("inf"), dtype=GEOM_DTYPE, device=device)
        for i, t in enumerate(grp):
            n = len(tri_data[t][3])
            xs[i, :, :n] = xs_of[t]
            Rs[i] = np.stack([R_of_view[v] for v in triplets[t]])
            valid[i, :n] = True
            prec[i] = cfg.max_residual_px / min(focal[v] for v in triplets[t])
            gumbel[i, :, :n] = ransac.gumbel_table(
                [pair_generator(seed, TRIPLET_STREAM + t, device)], n_draws, n, GEOM_DTYPE,
                device)[0]

        def d(a):
            return torch.as_tensor(a, dtype=GEOM_DTYPE, device=device)

        res = tt.triplet_translation_acransac_batch(
            None, d(xs), d(Rs), torch.as_tensor(valid, device=device), n_samples=S,
            precision_norm=d(prec), gumbel=gumbel)
        found = res.found.cpu().numpy()
        ts = res.ts.cpu().numpy()
        inl = res.inliers.cpu().numpy()
        for i, t in enumerate(grp):
            results[t] = (bool(found[i]), ts[i], inl[i, :len(tri_data[t][3])])
    return results


def compute_triplet_translations(scene, index, triplets, R_of_view, cfg, seed, device):
    """Edge coverage (GlobalSfM_translation_averaging.cpp:440-637): for
    every edge not yet covered, try its triplets, most shared tracks
    first, until one is accepted; an accepted triplet emits its three
    relative motions as one scale group and covers its edges.

    Returns (rel_motions [(group, (vi, vj), R_ij, t_ij)], inlier track ids)."""
    tri_data = {}
    edge_tris = defaultdict(list)
    for t_idx, (i, j, k) in enumerate(triplets):
        xa, xb, xc, tids = _shared_track_corr3(index, i, j, k)
        if len(tids) < cfg.triplet_min_tracks:
            continue
        tri_data[t_idx] = (xa, xb, xc, tids)
        for e in ((i, j), (j, k), (i, k)):
            edge_tris[tuple(sorted(e))].append(t_idx)

    verdicts = _evaluate_triplets_batched(scene, triplets, tri_data, R_of_view, cfg, seed,
                                          device)
    rel_motions = []
    inlier_track_ids = set()
    covered = set()
    group = 0
    for edge in sorted(edge_tris):
        if edge in covered:
            continue
        for t_idx in sorted(edge_tris[edge], key=lambda t: -len(tri_data[t][3])):
            tri = triplets[t_idx]
            tri_edges = [tuple(sorted(e)) for e in ((tri[0], tri[1]), (tri[1], tri[2]),
                                                    (tri[0], tri[2]))]
            if all(e in covered for e in tri_edges):
                continue
            found, ts, inl = verdicts[t_idx]
            if not found or inl.sum() <= cfg.triplet_min_inliers:
                continue
            covered.update(tri_edges)
            for a, b in ((0, 1), (1, 2), (0, 2)):
                Rab = R_of_view[tri[b]] @ R_of_view[tri[a]].T
                rel_motions.append((group, (tri[a], tri[b]), Rab, ts[b] - Rab @ ts[a]))
            group += 1
            inlier_track_ids.update(tri_data[t_idx][3][inl].tolist())
            break
    return rel_motions, inlier_track_ids


def global_sfm(scene: Scene, features: List[np.ndarray],
               matches: Dict[Tuple[int, int], np.ndarray],
               cfg: GlobalConfig = GlobalConfig(), seed: int = 0, device=None, stats=None):
    """Run the global pipeline; mutates and returns `scene`.

    features[v]: (N_v, >= 2) feature positions of view v; matches[(i, j)]:
    (M, 2) feature index pairs.  device: None = cuda (raises without a
    card); pass "cpu" to run on the CPU.  stats, a dict if given, receives
    the accepted f64 polish steps and `rounds`, the final BA's runs (one
    plus one per rejector pass)."""
    device = resolve_device(device)
    stats = {} if stats is None else stats
    stats.update(rounds=0, polish_steps=0)
    tracks = build_tracks(matches, min_length=2)
    index = _TrackIndex(tracks, features)

    keep = graphlib.largest_biedge_connected_component(list(matches))
    pairs = [p for p in matches if p[0] in keep and p[1] in keep]
    _log(cfg, f"{len(pairs)} pairs in the largest bi-edge CC ({len(keep)} views)")

    with stage("relative_poses"):
        rel = compute_relative_poses(scene, index, pairs, cfg, seed, device)
    _log(cfg, f"{len(rel)} relative poses")
    if len(rel) < 3:
        raise RuntimeError("not enough relative poses")

    R_map = {p: r["R"] for p, r in rel.items()}
    kept_pairs, triplets = ra.triplet_rotation_rejection(list(rel), R_map,
                                                         cfg.triplet_max_angle_deg)
    if len(kept_pairs) < 3:
        kept_pairs = set(rel)
    _log(cfg, f"{len(kept_pairs)} pairs after triplet rejection ({len(triplets)} triplets)")

    views = sorted({v for p in kept_pairs for v in p})
    vmap_ = {v: i for i, v in enumerate(views)}
    ei = np.asarray([vmap_[i] for (i, j) in kept_pairs])
    ej = np.asarray([vmap_[j] for (i, j) in kept_pairs])
    R_rel = np.stack([R_map[p] for p in kept_pairs])
    w = np.asarray([rel[p]["n_inliers"] for p in kept_pairs], float)

    with stage("rotation_averaging"):
        fn = (ra.l2_rotation_averaging if cfg.rotation_averaging == ROTATION_AVERAGING_L2
              else ra.l1_rotation_averaging)
        R_glob = fn(len(views), ei, ej, R_rel, w / w.max(), device=device).cpu().numpy()

    # the global stages are few and long: the stage boundaries are the
    # deadline's stop points.  Without positions there is nothing to keep.
    if deadline.past():
        _log(cfg, "deadline reached: stopping before translation averaging")
        return scene

    method = {TRANSLATION_AVERAGING_L1: ta.L1, TRANSLATION_AVERAGING_L2_CHORDAL: ta.L2,
              TRANSLATION_AVERAGING_SOFTL1: ta.SOFTL1}[cfg.translation_averaging]
    spherical = any(int(scene.cameras.kind[scene.view_intrinsic[v]]) == cm.SPHERICAL
                    for v in views)
    tri_inlier_tids = None
    t_glob = None
    with stage("translation_averaging"):
        if cfg.triplet_translation and triplets and not spherical:
            R_of_view = {v: R_glob[vmap_[v]] for v in views}
            rel_motions, tids = compute_triplet_translations(scene, index, triplets, R_of_view,
                                                             cfg, seed, device)
            covered_views = {v for _, e, _, _ in rel_motions for v in e}
            _log(cfg, f"triplet translations: {len(rel_motions)} motions "
                      f"({len(rel_motions) // 3} triplets), "
                      f"{len(covered_views)}/{len(views)} views covered")
            if covered_views == set(views):
                t_glob, _ = ta.solve_translation_averaging(
                    len(views), np.asarray([vmap_[e[0]] for _, e, _, _ in rel_motions]),
                    np.asarray([vmap_[e[1]] for _, e, _, _ in rel_motions]),
                    np.stack([R for _, _, R, _ in rel_motions]),
                    np.stack([t for _, _, _, t in rel_motions]), method=method,
                    scale_group=np.asarray([g for g, _, _, _ in rel_motions]), device=device)
                tri_inlier_tids = tids
        if t_glob is None:
            # two-view translations, with the averaged rotations substituted
            t_rel = np.stack([rel[p]["t"] for p in kept_pairs])
            R_rel_avg = np.einsum("eij,ekj->eik", R_glob[ej], R_glob[ei])
            t_glob, _ = ta.solve_translation_averaging(len(views), ei, ej, R_rel_avg, t_rel,
                                                       method=method, device=device)

    for v, i in vmap_.items():
        pid = scene.view_pose[v]
        scene.pose_valid[pid] = True
        scene.pose_R[pid] = R_glob[i]
        scene.pose_C[pid] = -R_glob[i].T @ t_glob[i]
    if deadline.past():  # a pose-only scene is a meaningful partial result
        _log(cfg, "deadline reached: returning the poses without structure")
        return scene

    landmark_of_track = np.full(index.n_tracks, -1, np.int64)
    posed_mask = np.zeros(scene.n_views, bool)
    posed_mask[views] = True
    rows_posed = posed_mask[index.tracks.view_id]
    cand = np.bincount(index.tracks.track_id[rows_posed], minlength=index.n_tracks)
    cand_tracks = np.nonzero(cand >= cfg.min_track_views)[0]
    if tri_inlier_tids:
        # initial structure from the triplet-validated tracks only
        # (Compute_Initial_Structure over tripletWise_matches :318-415)
        validated = cand_tracks[np.isin(cand_tracks,
                                        np.fromiter(tri_inlier_tids, np.int64))]
        if len(validated) >= 16:
            cand_tracks = validated
    tri_cfg = types.SimpleNamespace(triangulation_angle_deg=2.0,
                                    max_residual_px=cfg.max_residual_px)
    with stage("initial_structure"):
        n_rec = _reconstruct_tracks(scene, index, cand_tracks, landmark_of_track, tri_cfg,
                                    device)
    if cfg.verbose:
        _log(cfg, f"initial structure: {n_rec}/{len(cand_tracks)} tracks, "
                  f"rmse={rmse(scene):.3f}")

    with stage("staged_ba"):
        _staged_ba(scene, cfg, device)
        filters.remove_outliers_pixel_residual(scene, cfg.max_residual_px, 2)
        filters.remove_outliers_angle_error(scene, 2.0)
        filters.erase_unstable_poses_and_observations(scene, 12, 3)
        _run_ba(scene, cfg, device)
        stats["rounds"] = 1
        while (not deadline.past()
               and filters.bad_track_rejector(scene, cfg.max_residual_px, 50)):
            _run_ba(scene, cfg, device)
            stats["rounds"] += 1
    if cfg.f64_polish:
        with stage("f64_polish"):
            stats["polish_steps"] = f64_polish(
                scene, refine_intrinsics=cfg.refine_intrinsics != ba.ADJUST_NONE)
    if cfg.verbose:
        _log(cfg, f"done: {int(scene.pose_valid.sum())} poses, {scene.n_landmarks} landmarks, "
                  f"rmse={rmse(scene):.3f}")
    return scene


def _staged_ba(scene, cfg, device):
    """BA(T+X) -> BA(RT+X) -> BA(KRT+X) (engine Adjust :418-532).  Past
    the deadline only the last, full stage runs: the first two are warm
    starts."""
    stages = ((False, ba.ADJUST_NONE), (True, ba.ADJUST_NONE), (True, cfg.refine_intrinsics))
    if deadline.past():
        stages = stages[-1:]
    for refine_rot, refine_intr in stages:
        prob, maps = ba.problem_from_scene(scene, refine_rotation=refine_rot,
                                           refine_translation=True,
                                           refine_intrinsics=refine_intr, dtype=cfg.dtype,
                                           device=device)
        if len(maps["pose_ids"]) == 0 or prob.intr_params.shape[0] == 0:
            return
        prob, _, _ = ba.adjust(prob, ba.BAConfig(max_iterations=cfg.ba_iterations))
        ba.scene_from_problem(scene, prob, maps)
