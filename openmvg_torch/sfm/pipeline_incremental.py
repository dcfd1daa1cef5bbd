"""Incremental (sequential) SfM engine, versions 1 and 2 (counterpart:
openmvg_tpu/sfm/pipeline_incremental.py; openMVG sequential_SfM.cpp
SequentialSfMReconstructionEngine and sequential_SfM2.cpp).

  tracks -> automatic initial pair (robust relative pose, median
  triangulation angle in [3, 60] deg) -> initial structure and BA ->
  loop { a group of unposed views -> resection (AC-RANSAC P3P, pose
  refine) -> new-track triangulation -> BA until the bad-track rejector is
  quiet -> erase unstable poses } -> final BA -> f64 polish.

Version 1 (INCREMENTAL) takes the views with >= 75% of the best 2D-3D
count each round; version 2 (INCREMENTALV2) every view whose
reconstructed-track coverage passes a ratio schedule {0.2, 0.0}, and its
round cleanup also drops landmarks under 2 degrees of parallax.

The outer loop runs on the host.  Each inner step is a batched device
call: AC-RANSAC over a batch of pairs or views, N-view triangulation of
all new tracks at once, and the Schur-CG bundle adjuster over the whole
scene (float32 by default, IncrementalConfig.dtype).  The geometric
solvers (bearings, AC-RANSAC, triangulation, pose refine) run in float64
on the device (GEOM_DTYPE): their polynomial roots and 4x4 eigenproblems
are fragile in float32, and Hopper's float64 rate is half its float32
rate.  Each pair or view draws from its own torch.Generator seeded from
(seed, position), as the reference folds its key.  Stage seconds sum into
utils.logging.stage_times under the reference's names.
"""

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from openmvg_torch.io.ply import save_scene_ply
from openmvg_torch.io.snapshot import save_snapshot
from openmvg_torch.models import cameras as cm
from openmvg_torch.sfm import ba, filters, robust
from openmvg_torch.sfm.geometric_filter import pair_generator
from openmvg_torch.sfm.polish import f64_polish
from openmvg_torch.sfm.scene import Scene, rmse
from openmvg_torch.sfm.scene_triangulation import triangulate_tracks
from openmvg_torch.sfm.tracks import Tracks, build_tracks
from openmvg_torch.utils import deadline, hostmath
from openmvg_torch.utils.device import resolve_device
from openmvg_torch.utils.logging import stage

GEOM_DTYPE = torch.float64


@dataclasses.dataclass
class IncrementalConfig:
    # AUTO_PAIR (scored search) | MAX_PAIR (most-matched pair) |
    # EXISTING_POSES (seed from the scene's valid poses)
    initializer: str = "AUTO_PAIR"
    initial_pair: Optional[Tuple[int, int]] = None
    ransac_samples: int = 1024
    resection_samples: int = 1024
    init_pair_samples: int = 4096   # MakeInitialPair3D (sequential_SfM.cpp:532)
    min_angle_init_deg: float = 3.0
    max_angle_init_deg: float = 60.0
    min_init_inliers: int = 100
    resection_pct: float = 0.75       # FindImagesWithPossibleResection ratio
    min_resection_inliers_factor: float = 2.5
    triangulation_angle_deg: float = 2.0
    max_residual_px: float = 4.0
    ba_iterations: int = 30
    refine_intrinsics: object = ba.ADJUST_ALL
    min_points_per_pose: int = 6
    verbose: bool = False
    max_candidate_pairs: int = 20
    dtype: object = torch.float32     # bundle adjustment on the device
    # after each round, round_NNN.ply and latest_snapshot.npz go here
    # (sequential_SfM.cpp:200-203 dumps; the snapshot is a checkpoint)
    dump_dir: str = ""
    # 2 = INCREMENTALV2 (sequential_SfM2.cpp:84-203): each round resects
    # every unposed view whose reconstructed-track coverage exceeds the
    # schedule's ratio, and the round cleanup adds the 2 deg angle filter
    engine_version: int = 1
    v2_track_inlier_ratios: Tuple[float, ...] = (0.2, 0.0)
    f64_polish: bool = True
    # mid-round BA stops early; the final BA and the polish run in full
    ba_round_ftol: float = 1e-4
    ba_round_iterations: int = 12


def _log(cfg, *msg):
    if cfg.verbose:
        print("[incremental]", *msg, flush=True)


class _TrackIndex:
    """Per-view and per-track lookup over the flat track table."""

    def __init__(self, tracks: Tracks, features: List[np.ndarray]):
        self.tracks = tracks
        self.features = features
        self.n_tracks = tracks.n_tracks
        order = np.argsort(tracks.view_id, kind="stable")
        uniq, starts = np.unique(tracks.view_id[order], return_index=True)
        self._by_view = {int(v): sel for v, sel in zip(uniq, np.split(order, starts[1:]))}
        # posed-observation count of each track at its last failed
        # triangulation: a track is retried only once it gains observations
        self.last_tri_nobs = np.zeros(tracks.n_tracks, np.int64)
        if len(features):
            feats_xy = np.concatenate([np.asarray(f)[:, :2] if len(f) else np.zeros((0, 2))
                                       for f in features])
            offsets = np.zeros(len(features) + 1, np.int64)
            np.cumsum([len(f) for f in features], out=offsets[1:])
            self.obs_xy = feats_xy[offsets[tracks.view_id] + tracks.feat_id]
        else:
            self.obs_xy = np.zeros((len(tracks.track_id), 2))

    def rows_of_view(self, v):
        return self._by_view.get(int(v), np.zeros(0, np.int64))


def _bearings(scene, view_ids, xy, device):
    """Pixels -> unit bearings (numpy) through each view's camera, on the
    device."""
    iid = scene.view_intrinsic[view_ids]
    rows = cm.camera_rows(scene.cameras, iid, GEOM_DTYPE, device)
    b = cm.bearing(*rows, torch.as_tensor(np.asarray(xy), dtype=GEOM_DTYPE, device=device))
    return b.cpu().numpy()


def _shared_track_corr(index: _TrackIndex, va, vb):
    """Correspondences (xa, xb, track_ids) of the tracks seen in both views."""
    ra, rb = index.rows_of_view(va), index.rows_of_view(vb)
    common, ia, ib = np.intersect1d(index.tracks.track_id[ra], index.tracks.track_id[rb],
                                    return_indices=True)
    return index.obs_xy[ra[ia]], index.obs_xy[rb[ib]], common


def _is_spherical(scene, v):
    return int(scene.cameras.kind[scene.view_intrinsic[v]]) == cm.SPHERICAL


def _pad_rows(arrs, n, k):
    """Stack per-row arrays of lengths n_i into (B, k, ...) zero-padded."""
    out = np.zeros((len(arrs), k) + np.asarray(arrs[0]).shape[1:])
    for i, (a, m) in enumerate(zip(arrs, n)):
        out[i, :m] = a
    return out


def _median_angle(R, ba_, bb_, inl):
    if not inl.any():
        return 0.0
    rays_b = np.einsum("ji,nj->ni", R, bb_[inl])
    cosang = np.clip(np.sum(ba_[inl] * rays_b, 1), -1, 1)
    return float(np.degrees(np.median(np.arccos(cosang))))


def _pair_info(va, vb, info, i, n, ba_, bb_, tids):
    inl = info.inliers[i, :n].cpu().numpy()
    R = info.R[i].cpu().numpy()
    return dict(view_a=va, view_b=vb, R=R, t=info.t[i].cpu().numpy(), inliers=inl,
                track_ids=tids, n_inliers=int(inl.sum()),
                med_angle=_median_angle(R, ba_, bb_, inl), nfa=float(info.nfa[i]),
                threshold_px=float(np.sqrt(float(info.threshold_sq[i]))))


def _pair_tensors(scene, recs, device):
    """Padded (B, K, ...) tensors of a list of pair records."""
    n = [len(r["tids"]) for r in recs]
    k = max(n)

    def t(a):
        return torch.as_tensor(a, dtype=GEOM_DTYPE, device=device)

    K_all = hostmath.K_matrix_np(np.asarray(scene.cameras.params, np.float64))
    valid = torch.as_tensor(np.arange(k)[None, :] < np.asarray(n)[:, None], device=device)
    return (t(_pad_rows([r["ba"] for r in recs], n, k)), t(_pad_rows([r["bb"] for r in recs], n, k)),
            t(_pad_rows([r["xa"] for r in recs], n, k)), t(_pad_rows([r["xb"] for r in recs], n, k)),
            t(np.stack([K_all[scene.view_intrinsic[r["va"]]] for r in recs])),
            t(np.stack([K_all[scene.view_intrinsic[r["vb"]]] for r in recs])), valid,
            t([scene.view_wh[r["vb"]][0] for r in recs]),
            t([scene.view_wh[r["vb"]][1] for r in recs]))


def relative_pose_batch(scene, index, pair_list, seed, device, n_samples=1024, min_corr=15,
                        chunk=None):
    """Batched Relative_Pose_Engine (relative_pose_engine.cpp:144-191):
    correspondences of every pair gathered up front, bearings in one device
    call, then AC-RANSAC on `chunk` pairs per device call (default
    4096 // n_samples, which bounds the (pairs, samples, K) residual
    tables).  Pair `pos` draws from generator (seed, pos).  Returns
    {(va, vb): dict(R, t, inliers, track_ids, n_inliers, med_angle, nfa,
    threshold_px)} for the pairs found, in pair_list order."""
    if chunk is None:
        chunk = max(1, 4096 // max(n_samples, 1))
    recs = []
    for pos, (va, vb) in enumerate(pair_list):
        xa, xb, tids = _shared_track_corr(index, va, vb)
        if len(tids) >= min_corr:
            recs.append(dict(pos=pos, va=int(va), vb=int(vb), xa=xa, xb=xb, tids=tids))
    if not recs:
        return {}
    xy = np.concatenate([np.concatenate([r["xa"], r["xb"]]) for r in recs])
    views = np.concatenate([np.r_[np.full(len(r["xa"]), r["va"]), np.full(len(r["xb"]), r["vb"])]
                            for r in recs])
    b_cat = _bearings(scene, views, xy, device)
    ofs = 0
    for r in recs:
        n = len(r["tids"])
        r["ba"], r["bb"] = b_cat[ofs:ofs + n], b_cat[ofs + n:ofs + 2 * n]
        ofs += 2 * n
    groups = {}
    for r in recs:
        groups.setdefault(_is_spherical(scene, r["va"]) or _is_spherical(scene, r["vb"]),
                          []).append(r)
    out = {}
    for angular, rs in groups.items():
        for lo in range(0, len(rs), chunk):
            grp = rs[lo:lo + chunk]
            gens = [pair_generator(seed, r["pos"], device) for r in grp]
            info = robust.robust_relative_pose_batch(
                gens, *_pair_tensors(scene, grp, device), n_samples=n_samples,
                angular=angular)
            found = info.found.cpu().numpy()
            for i, r in enumerate(grp):
                if found[i]:
                    out[(r["va"], r["vb"])] = _pair_info(r["va"], r["vb"], info, i,
                                                         len(r["tids"]), r["ba"], r["bb"],
                                                         r["tids"])
    return {p: out[p] for p in map(tuple, pair_list) if p in out}


def _refine_pair(scene, index, cfg, seed, pos, va, vb, device):
    """MakeInitialPair3D's refinement of one pair: adaptive AC-RANSAC with
    the init_pair_samples budget in rounds of 512."""
    xa, xb, tids = _shared_track_corr(index, va, vb)
    n = len(tids)
    if n < max(cfg.min_init_inliers // 2, 15):
        return None
    b = _bearings(scene, np.r_[np.full(n, va), np.full(n, vb)], np.concatenate([xa, xb]),
                  device)
    rec = dict(va=va, vb=vb, xa=xa, xb=xb, tids=tids, ba=b[:n], bb=b[n:])
    round_size = min(512, cfg.init_pair_samples)
    info, _ = robust.robust_relative_pose_adaptive(
        [pair_generator(seed, pos, device)], *_pair_tensors(scene, [rec], device),
        round_size=round_size, max_rounds=max(1, -(-cfg.init_pair_samples // round_size)),
        angular=_is_spherical(scene, va) or _is_spherical(scene, vb))
    if not bool(info.found[0]):
        return None
    return _pair_info(va, vb, info, 0, n, rec["ba"], rec["bb"], tids)


def choose_initial_pair(scene, index, matches, cfg, seed, device):
    """AutomaticInitialPairChoice: score the most-connected candidate pairs
    in one batched call; returns them sorted best first (the caller falls
    through to the next when one does not triangulate)."""
    cand = sorted(matches.keys(), key=lambda p: -len(matches[p]))[:cfg.max_candidate_pairs]
    infos = relative_pose_batch(scene, index, cand, seed, device, n_samples=cfg.ransac_samples,
                                min_corr=max(cfg.min_init_inliers // 2, 15))

    def score(r):
        in_range = cfg.min_angle_init_deg <= r["med_angle"] <= cfg.max_angle_init_deg
        return r["n_inliers"] * (1.0 if in_range else 0.05)

    return sorted(infos.values(), key=score, reverse=True)


def _init_pair_triangulation_count(scene, index, info, cfg):
    """How many of the pair's inliers triangulate within the residual,
    angle and cheirality gates under its (R, t): MakeInitialPair3D's
    acceptance test, host-side 4x4 DLT per point."""
    va, vb = info["view_a"], info["view_b"]
    if _is_spherical(scene, va) or _is_spherical(scene, vb):
        return info["n_inliers"]
    xa, xb, _ = _shared_track_corr(index, va, vb)
    xa, xb = xa[info["inliers"]], xb[info["inliers"]]
    if len(xa) == 0:
        return 0
    R, t = info["R"], info["t"]
    params = np.asarray(scene.cameras.params)
    Ka = hostmath.K_matrix_np(params[scene.view_intrinsic[va]])
    Kb = hostmath.K_matrix_np(params[scene.view_intrinsic[vb]])
    P1 = Ka @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = Kb @ np.hstack([R, t[:, None]])
    A = np.stack([xa[:, 0, None] * P1[2] - P1[0], xa[:, 1, None] * P1[2] - P1[1],
                  xb[:, 0, None] * P2[2] - P2[0], xb[:, 1, None] * P2[2] - P2[1]], axis=1)
    X = np.linalg.svd(A)[2][:, -1, :]
    X = X[:, :3] / np.where(np.abs(X[:, 3:]) < 1e-30, 1e-30, X[:, 3:])
    z1 = X[:, 2]
    Xc2 = X @ R.T + t
    z2 = Xc2[:, 2]
    p1 = (X / np.where(np.abs(z1[:, None]) < 1e-30, 1e-30, z1[:, None])) @ Ka.T
    p2 = (Xc2 / np.where(np.abs(z2[:, None]) < 1e-30, 1e-30, z2[:, None])) @ Kb.T
    r1 = np.linalg.norm(p1[:, :2] - xa, axis=1)
    r2 = np.linalg.norm(p2[:, :2] - xb, axis=1)
    rays1 = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-30)
    d2 = X + R.T @ t
    rays2 = d2 / np.maximum(np.linalg.norm(d2, axis=1, keepdims=True), 1e-30)
    ang = np.degrees(np.arccos(np.clip(np.sum(rays1 * rays2, 1), -1, 1)))
    good = ((z1 > 0) & (z2 > 0) & (r1 <= cfg.max_residual_px) & (r2 <= cfg.max_residual_px)
            & (ang >= cfg.triangulation_angle_deg))
    return int(good.sum())


def _append_observations(scene, track_rows, index, landmark_of_track):
    tr = index.tracks
    ol = landmark_of_track[tr.track_id[track_rows]]
    scene.obs_landmark = np.concatenate([scene.obs_landmark, ol.astype(np.int32)])
    scene.obs_view = np.concatenate([scene.obs_view, tr.view_id[track_rows]])
    scene.obs_x = np.concatenate([scene.obs_x, index.obs_xy[track_rows]])
    scene.obs_feat = np.concatenate([scene.obs_feat, tr.feat_id[track_rows]])
    scene.obs_valid = np.concatenate([scene.obs_valid, np.ones(len(track_rows), bool)])


def _timed_rejector(scene, cfg, count_threshold=50):
    with stage("rejector"):
        return filters.bad_track_rejector(scene, cfg.max_residual_px, count_threshold)


def _run_ba(scene, cfg, device, refine_intrinsics=None, function_tolerance=None,
            max_iterations=None):
    with stage("bundle_adjustment"):
        with stage("ba_build"):
            prob, maps = ba.problem_from_scene(
                scene, refine_intrinsics=cfg.refine_intrinsics
                if refine_intrinsics is None else refine_intrinsics,
                dtype=cfg.dtype, device=device)
        if len(maps["pose_ids"]) == 0 or prob.intr_params.shape[0] == 0:
            return
        with stage("ba_solve"):
            bacfg = ba.BAConfig(max_iterations=cfg.ba_iterations
                                if max_iterations is None else max_iterations)
            if function_tolerance is not None:
                bacfg = bacfg._replace(function_tolerance=function_tolerance)
            prob, _, _ = ba.adjust(prob, bacfg)
        with stage("ba_write"):
            ba.scene_from_problem(scene, prob, maps)


def incremental_sfm(scene: Scene, features: List[np.ndarray],
                    matches: Dict[Tuple[int, int], np.ndarray],
                    cfg: IncrementalConfig = IncrementalConfig(), seed: int = 0, device=None,
                    stats=None):
    """Run the whole incremental pipeline; mutates and returns `scene`.

    features[v]: (N_v, >= 2) feature positions of view v; matches[(i, j)]:
    (M, 2) feature index pairs.  device: None = cuda (raises without a
    card); pass "cpu" to run on the CPU.  stats, a dict if given, receives
    the round count and the accepted f64 polish steps."""
    device = resolve_device(device)
    stats = {} if stats is None else stats
    tracks = build_tracks(matches, min_length=2)
    index = _TrackIndex(tracks, features)
    _log(cfg, f"{tracks.n_tracks} tracks")
    landmark_of_track = np.full(tracks.n_tracks, -1, np.int64)

    if cfg.initializer.upper() == "EXISTING_POSES" and scene.pose_valid.any():
        posed = {v for v in range(scene.n_views)
                 if scene.view_pose[v] >= 0 and scene.pose_valid[scene.view_pose[v]]}
        cand = np.nonzero(np.bincount(tracks.track_id[np.isin(tracks.view_id, list(posed))],
                                      minlength=tracks.n_tracks) >= 2)[0]
        _reconstruct_tracks(scene, index, cand, landmark_of_track, cfg, device)
        _run_ba(scene, cfg, device)
        _log(cfg, f"init from {len(posed)} existing poses: {scene.n_landmarks} landmarks")
    else:
        min_corr = max(cfg.min_init_inliers // 2, 15)
        if cfg.initial_pair is not None or cfg.initializer.upper() == "MAX_PAIR":
            pair = (tuple(cfg.initial_pair) if cfg.initial_pair is not None
                    else tuple(max(matches, key=lambda p: len(matches[p]))))
            found = relative_pose_batch(scene, index, [pair], seed, device,
                                        n_samples=cfg.ransac_samples, min_corr=min_corr)
            cands = [found[pair]] if pair in found else []
            if not cands:
                raise RuntimeError(f"initial pair {pair} failed")
        else:
            cands = choose_initial_pair(scene, index, matches, cfg, seed, device)
            if not cands:
                raise RuntimeError("no valid initial pair found")
        # MakeInitialPair3D: refine, then accept the model that
        # triangulates the most inliers; fall through to the next candidate
        init, n_tri_best = None, -1
        for ci, cand in enumerate(cands[:5]):
            options = [cand]
            if cfg.init_pair_samples > cfg.ransac_samples:
                refined = _refine_pair(scene, index, cfg, seed, 2 ** 31 - 1 - ci,
                                       cand["view_a"], cand["view_b"], device)
                if refined is not None:
                    options.append(refined)
            for opt in options:
                n_tri = _init_pair_triangulation_count(scene, index, opt, cfg)
                if n_tri > n_tri_best:
                    init, n_tri_best = opt, n_tri
            if n_tri_best >= max(30, cfg.min_init_inliers // 2):
                break
        if init is None or n_tri_best < 16:
            raise RuntimeError("no triangulable initial pair found")
        va, vb = init["view_a"], init["view_b"]
        _log(cfg, f"initial pair ({va},{vb}) inliers={init['n_inliers']} "
                  f"angle={init['med_angle']:.1f} tri={n_tri_best}")
        pa, pb = scene.view_pose[va], scene.view_pose[vb]
        scene.pose_valid[pa] = True
        scene.pose_R[pa] = np.eye(3)
        scene.pose_C[pa] = 0.0
        scene.pose_valid[pb] = True
        scene.pose_R[pb] = init["R"]
        scene.pose_C[pb] = -init["R"].T @ init["t"]
        _reconstruct_tracks(scene, index, init["track_ids"][init["inliers"]],
                            landmark_of_track, cfg, device)
        _run_ba(scene, cfg, device)
        while filters.bad_track_rejector(scene, cfg.max_residual_px, 50):
            _run_ba(scene, cfg, device)
        _log(cfg, f"init: {scene.n_landmarks} landmarks rmse={rmse(scene):.3f}")
        posed = {int(va), int(vb)}
    failed_rounds: Dict[int, int] = {}
    round_id = 0

    def resect_group(group):
        with stage("resection"):
            ok_views = _resect_views_batch(scene, index, group, landmark_of_track, cfg, seed,
                                           round_id, device)
            for v in group:
                if int(v) in ok_views:
                    posed.add(int(v))
                else:
                    failed_rounds[int(v)] = failed_rounds.get(int(v), 0) + 1
        return len(ok_views)

    def round_cleanup(added):
        with stage("triangulation"):
            _grow_structure(scene, index, posed, landmark_of_track, cfg, device)
        _run_ba(scene, cfg, device, function_tolerance=cfg.ba_round_ftol,
                max_iterations=cfg.ba_round_iterations)
        while _timed_rejector(scene, cfg):
            _run_ba(scene, cfg, device, function_tolerance=cfg.ba_round_ftol,
                    max_iterations=cfg.ba_round_iterations)
        with stage("filters"):
            if cfg.engine_version == 2:
                filters.remove_outliers_angle_error(scene, 2.0)   # sequential_SfM2.cpp:166
            filters.erase_unstable_poses_and_observations(scene, cfg.min_points_per_pose)
        gone = np.nonzero(~scene.X_valid)[0]
        if len(gone):
            mask = np.isin(landmark_of_track, gone)
            landmark_of_track[mask] = -1
            index.last_tri_nobs[mask] = 0  # erased tracks may be retried
        _log(cfg, f"round {round_id}: +{added} views ({len(posed)} total), "
                  f"{scene.n_landmarks} landmarks")
        if cfg.dump_dir:
            os.makedirs(cfg.dump_dir, exist_ok=True)
            save_scene_ply(scene, os.path.join(cfg.dump_dir, f"round_{round_id:03d}.ply"))
            save_snapshot(scene, os.path.join(cfg.dump_dir, "latest_snapshot.npz"))

    if cfg.engine_version == 2:
        # the track-inlier-ratio schedule (sequential_SfM2.cpp:155-183): a
        # round that adds nothing moves to the next, looser ratio; any
        # growth goes back to the strictest
        ratios = list(cfg.v2_track_inlier_ratios)
        r_idx = 0
        while r_idx < len(ratios):
            with stage("find_group"):
                group = _find_v2_group(scene, index, posed, landmark_of_track, ratios[r_idx],
                                       failed_rounds)
            if not group:
                r_idx += 1
                continue
            round_id += 1
            n_posed_before = len(posed)
            added = resect_group(group)
            if added:
                round_cleanup(added)
            r_idx = 0 if len(posed) > n_posed_before else r_idx + 1
            if deadline.past():
                _log(cfg, "deadline reached: stopping with a partial scene")
                break
    else:
        while True:
            round_id += 1
            with stage("find_group"):
                group = _find_resection_group(scene, index, posed, landmark_of_track, cfg,
                                              failed_rounds)
            if not group:
                break
            added = resect_group(group)
            if not added:
                break
            round_cleanup(added)
            if deadline.past():
                _log(cfg, "deadline reached: stopping with a partial scene")
                break

    _run_ba(scene, cfg, device)
    while not deadline.past() and _timed_rejector(scene, cfg, 0):
        _run_ba(scene, cfg, device)
    stats.update(rounds=round_id, polish_steps=0)
    if cfg.f64_polish:
        with stage("f64_polish"):
            stats["polish_steps"] = f64_polish(
                scene, refine_intrinsics=cfg.refine_intrinsics != ba.ADJUST_NONE)
        _log(cfg, f"f64 polish: {stats['polish_steps']} accepted steps")
    _log(cfg, f"done: {int(scene.pose_valid.sum())} poses, {scene.n_landmarks} landmarks, "
              f"rmse={rmse(scene):.3f}")
    return scene


def _reconstruct_tracks(scene, index, track_ids, landmark_of_track, cfg, device):
    """Triangulate the given tracks from all their posed observations and
    register the good ones as landmarks with their observations."""
    track_ids = np.unique(np.asarray(track_ids))
    track_ids = track_ids[landmark_of_track[track_ids] < 0]
    if len(track_ids) == 0:
        return 0
    tr = index.tracks
    rows = np.nonzero(np.isin(tr.track_id, track_ids))[0]
    pid = scene.view_pose[tr.view_id[rows]]
    rows = rows[(pid >= 0) & scene.pose_valid[np.clip(pid, 0, max(scene.n_poses - 1, 0))]]
    if len(rows) == 0:
        return 0
    tix = np.searchsorted(track_ids, tr.track_id[rows])
    X, okt = triangulate_tracks(scene, tr.view_id[rows], index.obs_xy[rows], tix,
                                len(track_ids), min_angle_deg=cfg.triangulation_angle_deg,
                                max_residual_px=cfg.max_residual_px, device=device,
                                dtype=GEOM_DTYPE)
    good = np.nonzero(okt)[0]
    if len(good) == 0:
        return 0
    base = len(scene.X_valid)
    scene.X = np.concatenate([scene.X, X[good]])
    scene.X_valid = np.concatenate([scene.X_valid, np.ones(len(good), bool)])
    new_ids = np.full(len(track_ids), -1, np.int64)
    new_ids[good] = base + np.arange(len(good))
    landmark_of_track[track_ids] = new_ids
    _append_observations(scene, rows[new_ids[tix] >= 0], index, landmark_of_track)
    return len(good)


def _find_resection_group(scene, index, posed, landmark_of_track, cfg, failed_rounds):
    """FindImagesWithPossibleResection: unposed views with at least 12
    2D-3D correspondences and >= resection_pct of the best count, most
    first; a view that failed three rounds is left out."""
    tr = index.tracks
    n2d3d = np.bincount(tr.view_id[landmark_of_track[tr.track_id] >= 0],
                        minlength=scene.n_views)
    eligible = np.ones(scene.n_views, bool)
    eligible[list(posed)] = False
    for v, f in failed_rounds.items():
        if f >= 3:
            eligible[v] = False
    counts = {int(v): int(n2d3d[v]) for v in np.nonzero(eligible & (n2d3d >= 12))[0]}
    if not counts:
        return []
    best = max(counts.values())
    group = [v for v, n in counts.items() if n >= cfg.resection_pct * best]
    return sorted(group, key=lambda v: -counts[v])


def _find_v2_group(scene, index, posed, landmark_of_track, ratio, failed_rounds):
    """AddingMissingView's candidates (sequential_SfM2.cpp:292-380): unposed
    views whose reconstructed-track coverage n_reconstructed / (n_tracks +
    1) exceeds `ratio`, most 2D-3D correspondences first; a view that
    failed three rounds is left out."""
    tr = index.tracks
    total = np.bincount(tr.view_id, minlength=scene.n_views)
    rec = np.bincount(tr.view_id[landmark_of_track[tr.track_id] >= 0],
                      minlength=scene.n_views)
    eligible = (rec > 0) & (rec / (total + 1.0) > ratio)
    eligible[list(posed)] = False
    for v, f in failed_rounds.items():
        if f >= 3:
            eligible[v] = False
    return sorted((int(v) for v in np.nonzero(eligible)[0]), key=lambda v: -rec[v])


def _resect_views_batch(scene, index, views, landmark_of_track, cfg, seed, round_id, device):
    """Batched Resection (sequential_SfM.cpp:863): AC-RANSAC P3P for every
    view of the group, `4096 // resection_samples` views per device call,
    then one batched pose-only LM refine of all accepted views
    (SfM_Localizer::RefinePose).  Returns the ids of the resected views."""
    tr = index.tracks
    recs = []
    for j, v in enumerate(views):
        rows = index.rows_of_view(v)
        lm = landmark_of_track[tr.track_id[rows]]
        sel = lm >= 0
        if sel.sum() >= 12:
            recs.append(dict(pos=1000 * round_id + j, v=int(v), rows=rows[sel], lm=lm[sel]))
    if not recs:
        return set()
    b_cat = _bearings(scene, np.concatenate([np.full(len(r["rows"]), r["v"]) for r in recs]),
                      np.concatenate([index.obs_xy[r["rows"]] for r in recs]), device)
    ofs = 0
    for r in recs:
        n = len(r["rows"])
        r["xy"], r["b"], r["X"] = index.obs_xy[r["rows"]], b_cat[ofs:ofs + n], scene.X[r["lm"]]
        ofs += n
    K_all = hostmath.K_matrix_np(np.asarray(scene.cameras.params, np.float64))

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=GEOM_DTYPE, device=device)

    chunk = max(1, 4096 // max(cfg.resection_samples, 1))
    accepted = []
    groups = {}
    for r in recs:
        groups.setdefault(_is_spherical(scene, r["v"]), []).append(r)
    for spherical, rs in groups.items():
        for lo in range(0, len(rs), chunk):
            grp = rs[lo:lo + chunk]
            n = [len(r["rows"]) for r in grp]
            k = max(n)
            b = t(_pad_rows([r["b"] for r in grp], n, k))
            X = t(_pad_rows([r["X"] for r in grp], n, k))
            valid = torch.as_tensor(np.arange(k)[None, :] < np.asarray(n)[:, None], device=device)
            gens = [pair_generator(seed, r["pos"], device) for r in grp]
            if spherical:
                res = robust.robust_resection_angular_batch(gens, b, X, valid,
                                                            n_samples=cfg.resection_samples)
            else:
                res = robust.robust_resection_p3p_batch(
                    gens, b, t(_pad_rows([r["xy"] for r in grp], n, k)), X,
                    t(np.stack([K_all[scene.view_intrinsic[r["v"]]] for r in grp])), valid,
                    t([scene.view_wh[r["v"]][0] for r in grp]),
                    t([scene.view_wh[r["v"]][1] for r in grp]), n_samples=cfg.resection_samples)
            found = res.found.cpu().numpy()
            inliers = res.inliers.cpu().numpy()
            R_all, t_all = (m.cpu().numpy() for m in res.model)
            for i, r in enumerate(grp):
                inl = inliers[i, :n[i]]
                if found[i] and inl.sum() >= cfg.min_resection_inliers_factor * 3:
                    accepted.append(dict(r, R=R_all[i], t=t_all[i], inl=inl))
    if not accepted:
        return set()

    n = [len(r["rows"]) for r in accepted]
    k = max(n)
    params = np.asarray(scene.cameras.params, np.float64)
    iid = np.array([scene.view_intrinsic[r["v"]] for r in accepted])
    rot_f, t_f = robust.refine_poses_batch(
        t(np.stack([hostmath.logmap_np(r["R"]) for r in accepted])),
        t(np.stack([r["t"] for r in accepted])),
        torch.as_tensor(np.asarray(scene.cameras.kind)[iid], device=device), t(params[iid]),
        t(np.stack([scene.view_wh[r["v"]] for r in accepted]).astype(np.float64)),
        t(_pad_rows([r["X"] for r in accepted], n, k)),
        t(_pad_rows([r["xy"] for r in accepted], n, k)),
        t(_pad_rows([r["inl"].astype(np.float64) for r in accepted], n, k)))
    rot_f, t_f = rot_f.cpu().numpy(), t_f.cpu().numpy()
    for i, r in enumerate(accepted):
        R = hostmath.expmap_np(rot_f[i])
        pid = scene.view_pose[r["v"]]
        scene.pose_valid[pid] = True
        scene.pose_R[pid] = R
        scene.pose_C[pid] = -R.T @ t_f[i]
    return {r["v"] for r in accepted}


def _grow_structure(scene, index, posed, landmark_of_track, cfg, device):
    """Triangulate not-yet-reconstructed tracks with >= 2 posed
    observations, then add the residual-gated observations of posed views
    to existing landmarks (Resection step 3, sequential_SfM.cpp:1000-1187)."""
    tr = index.tracks
    posed_mask = np.zeros(scene.n_views, bool)
    posed_mask[list(posed)] = True
    rows_posed = posed_mask[tr.view_id]
    cand = np.bincount(tr.track_id[rows_posed], minlength=index.n_tracks)
    new_tracks = np.nonzero((cand >= 2) & (landmark_of_track < 0)
                            & (cand > index.last_tri_nobs))[0]
    index.last_tri_nobs[new_tracks] = cand[new_tracks]
    _reconstruct_tracks(scene, index, new_tracks, landmark_of_track, cfg, device)

    lm = landmark_of_track[tr.track_id]
    nv = np.int64(scene.n_views)
    have = (scene.obs_landmark[scene.obs_valid].astype(np.int64) * nv
            + scene.obs_view[scene.obs_valid])
    rows = np.nonzero(rows_posed & (lm >= 0))[0]
    missing = rows[~np.isin(lm[rows].astype(np.int64) * nv + tr.view_id[rows], have)]
    if len(missing):
        vi = tr.view_id[missing]
        pid = scene.view_pose[vi]
        iid = scene.view_intrinsic[vi]
        Xc = np.einsum("nij,nj->ni", scene.pose_R[pid], scene.X[lm[missing]] - scene.pose_C[pid])
        cams = scene.cameras
        r = hostmath.residual_np(np.asarray(cams.kind)[iid], np.asarray(cams.params)[iid],
                                 np.asarray(cams.width)[iid], np.asarray(cams.height)[iid], Xc,
                                 index.obs_xy[missing])
        d = np.linalg.norm(r, axis=1)
        # cheirality: the camera z for a pinhole view; an equirectangular
        # view sees every direction and its residual gate already holds the
        # point on the observed ray (the reference tests the camera z here
        # too, which refuses every observation behind a SPHERICAL camera's
        # optical axis)
        front = (Xc[:, 2] > 0) | (np.asarray(cams.kind)[iid] == cm.SPHERICAL)
        okm = missing[(d <= cfg.max_residual_px) & front]
        if len(okm):
            _append_observations(scene, okm, index, landmark_of_track)
