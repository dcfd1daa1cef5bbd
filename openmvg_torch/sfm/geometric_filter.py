"""Collection geometric filtering of putative matches, batched over pairs
(counterpart: openmvg_tpu/sfm/geometric_filter.py).

Reference parity: matching_image_collection/GeometricFilter.hpp
Robust_model_estimation (:31-63) with the per-model AC-RANSAC functors
F/E/H/angular/upright/ortho (F_ACRobust.hpp:89, E_ACRobust.hpp,
H_ACRobust.hpp, E_ACRobust_Angular.hpp:34-111, Eo_Robust.hpp:50-120;
main_GeometricFilter.cpp:165-368): per pair, AC-RANSAC with an upper-bound
precision (4 px by default, 2.0 px for "o"; 2048 iterations); a pair is
kept when a meaningful model has more than 2.5 x MIN_SAMPLES inliers, and
only its inlier matches are kept.  "a" and "u" take no precision (their
ceiling is infinite), as in the reference.

Models and their dtype (dtype None picks it):
  f  7-point F on pixels, point-to-line NFA        float32
  h  4-point H on pixels, point-to-point NFA       float32 (conditioned
     like f, pixel residuals)
  e  5-point E on bearings, pixel point-to-line    float64
  a  8-point E on bearings, angular residual       float64
  u  3-point upright E, angular residual           float64
  o  3-point orthographic E on camera-plane points float64
The angular and camera-plane residuals are about 1e-3 before squaring, and
the 5-point roots are fragile in float32; the card's float64 makes that
cheap.  Bearings come from one device call over every correspondence.  For
"o" the points are the bearings' camera-plane coordinates, and each pair's
precision is 0.5 (thr / fa + thr / fb) for the squared pixel threshold thr
over focals that are not squared (reference :176-191, copied as it is).

Guided matching (-r, model "f" only): every kept pair's matches are taken
again over all features, gated by the pair's F at its AC-RANSAC threshold
(known_poses.guided_matching_batch: the 2-NN of all kept pairs in one K1
launch on the card); a pair takes the guided set when it holds at least
its AC-RANSAC inliers.

Pairs run in batches sized by memory (the residual table of a batch is
B x samples x models x N), sorted by correspondence count so padding stays
small.  Each pair draws from its own torch.Generator seeded from
(seed, position of the pair in sorted order), so its result does not
depend on the batch it lands in.  The streams differ from the
reference's jax.random ones; outcomes agree, draws do not.
"""

from typing import Dict, List, Tuple

import numpy as np
import torch

from openmvg_torch.models import cameras as cm
from openmvg_torch.ops import ransac
from openmvg_torch.sfm import known_poses, robust

MIN_SAMPLES = {"f": 7, "e": 5, "h": 4, "a": 8, "u": 3, "o": 3}
# models a sample: 7-point and 5-point solver roots, the ortho solver's two
_MAX_MODELS = {"f": 3, "e": 10, "h": 1, "a": 1, "u": 1, "o": 2}
# ortho runs at 2.0 px (GeometricFilter_EOMatrix_RA(2.0, ...),
# main_GeometricFilter.cpp:358-361), every other model at 4.0 px
ORTHO_DEFAULT_PRECISION_PX = 2.0
_BATCH_ELEMENTS = 1 << 27     # residual-table entries per batch


def pair_generator(seed, pos, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) * (1 << 32) + int(pos))
    return g


def geometric_filter(scene, features: List[np.ndarray],
                     matches: Dict[Tuple[int, int], np.ndarray],
                     model: str = "f", threshold_px: float = None,
                     n_samples: int = 2048, seed: int = 0,
                     guided: bool = False, descs: List[np.ndarray] = None,
                     device="cuda", dtype=None) -> Dict[Tuple[int, int], np.ndarray]:
    """Filter putative matches with the model `model` (f|e|h|a|u|o, see the
    module note).  guided=True (-r) re-matches the pairs that model "f"
    keeps over all their features and needs `descs`."""
    if model not in MIN_SAMPLES:
        raise ValueError(f"unknown model {model}")
    if threshold_px is None:
        threshold_px = ORTHO_DEFAULT_PRECISION_PX if model == "o" else 4.0
    if dtype is None:
        dtype = torch.float32 if model in ("f", "h") else torch.float64
    prec = threshold_px * threshold_px if np.isfinite(threshold_px) else np.inf
    s_min = MIN_SAMPLES[model]
    guided = guided and model == "f" and descs is not None

    recs = []
    for pos, ((va, vb), m) in enumerate(sorted(matches.items())):
        m = np.asarray(m)
        if len(m) <= s_min:
            continue
        recs.append(dict(pos=pos, va=int(va), vb=int(vb), m=m,
                         xa=features[va][m[:, 0], :2],
                         xb=features[vb][m[:, 1], :2]))
    recs.sort(key=lambda r: len(r["m"]))
    if model in ("e", "a", "u", "o") and recs:
        _bearings_of(scene, recs, dtype, device)
    if model == "o":
        params = np.asarray(scene.cameras.params, np.float64)
        thr_o = ORTHO_DEFAULT_PRECISION_PX ** 2 if not np.isfinite(prec) else prec
        for r in recs:
            r["ca"], r["cb"] = _camera_plane(r["ba"]), _camera_plane(r["bb"])
            fa = params[scene.view_intrinsic[r["va"]], 0]
            fb = params[scene.view_intrinsic[r["vb"]], 0]
            r["prec"] = 0.5 * (thr_o / fa + thr_o / fb)

    s1 = max(n_samples * 9 // 10, 1)
    n_draws = s1 + max(n_samples - s1, 1)
    batches, cur = [], []
    for r in recs:  # ascending size: r is the widest of cur + [r]
        if cur and (len(cur) + 1) * n_draws * _MAX_MODELS[model] * len(r["m"]) > _BATCH_ELEMENTS:
            batches.append(cur)
            cur = []
        cur.append(r)
    if cur:
        batches.append(cur)

    out, to_guide = {}, []
    for grp in batches:
        n_max = len(grp[-1]["m"])
        P = len(grp)
        valid = np.zeros((P, n_max), bool)
        gumbel = torch.full((P, n_draws, n_max), -float("inf"), dtype=dtype,
                            device=device)
        for i, r in enumerate(grp):
            n = len(r["m"])
            valid[i, :n] = True
            gumbel[i, :, :n] = ransac.gumbel_table(
                [pair_generator(seed, r["pos"], device)], n_draws, n, dtype,
                device)[0]
        wh_a = np.asarray([scene.view_wh[r["va"]] for r in grp], np.float64)
        wh_b = np.asarray([scene.view_wh[r["vb"]] for r in grp], np.float64)

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        def pad(field, width):
            a = np.zeros((P, n_max, width))
            for i, r in enumerate(grp):
                a[i, :len(r["m"])] = r[field]
            return t(a)

        valid_t = torch.as_tensor(valid, device=device)
        kw = dict(n_samples=n_samples, gumbel=gumbel)
        if model in ("f", "h"):
            fn = robust.robust_fundamental_batch if model == "f" else \
                robust.robust_homography_batch
            res = fn(None, pad("xa", 2), pad("xb", 2), valid_t, t(wh_a[:, 0]), t(wh_a[:, 1]),
                     t(wh_b[:, 0]), t(wh_b[:, 1]), precision_sq=prec, **kw)
        elif model == "e":
            K_all = cm.K_matrix_np(np.asarray(scene.cameras.params, np.float64))
            Ka = np.stack([K_all[scene.view_intrinsic[r["va"]]] for r in grp])
            Kb = np.stack([K_all[scene.view_intrinsic[r["vb"]]] for r in grp])
            res = robust.robust_essential_batch(
                None, pad("ba", 3), pad("bb", 3), pad("xa", 2), pad("xb", 2), t(Ka), t(Kb),
                valid_t, t(wh_b[:, 0]), t(wh_b[:, 1]), precision_sq=prec, **kw)
        elif model in ("a", "u"):
            fn = robust.robust_essential_angular_batch if model == "a" else \
                robust.robust_essential_upright_batch
            res = fn(None, pad("ba", 3), pad("bb", 3), valid_t, **kw)
        else:
            res = robust.robust_essential_ortho_batch(
                None, pad("ca", 2), pad("cb", 2), valid_t, t(wh_b[:, 0]), t(wh_b[:, 1]),
                t([r["prec"] for r in grp]), **kw)
        found = res.found.cpu().numpy()
        inliers = res.inliers.cpu().numpy()
        if guided:
            models = res.model.double().cpu().numpy()
            thr_sq = res.threshold_sq.double().cpu().numpy()
        for i, r in enumerate(grp):
            inl = inliers[i, :len(r["m"])]
            if found[i] and inl.sum() > 2.5 * s_min:
                out[(r["va"], r["vb"])] = r["m"][inl]
                if guided:
                    to_guide.append(((r["va"], r["vb"]), models[i],
                                     float(np.sqrt(thr_sq[i]))))
    if to_guide:
        gms = known_poses.guided_matching_batch(
            features, descs, [g[0] for g in to_guide], np.stack([g[1] for g in to_guide]),
            np.asarray([g[2] for g in to_guide]), device=device)
        for (pq, _, _), gm in zip(to_guide, gms):
            if len(gm) >= len(out[pq]):
                out[pq] = gm
    return {p: out[p] for p in sorted(out)}


def _camera_plane(b):
    """Bearings (N, 3) -> camera-plane points (N, 2), x / |z| sign(z)."""
    return b[:, :2] / np.maximum(np.abs(b[:, 2:]), 1e-12) * np.sign(b[:, 2:])


def _bearings_of(scene, recs, dtype, device):
    """Unit bearings of every correspondence of every pair in one device
    call, into each record's "ba" and "bb"."""
    xy = np.concatenate([np.concatenate([r["xa"], r["xb"]]) for r in recs])
    iid = np.concatenate([np.r_[np.full(len(r["m"]), scene.view_intrinsic[r["va"]]),
                                np.full(len(r["m"]), scene.view_intrinsic[r["vb"]])]
                          for r in recs])
    rows = cm.camera_rows(scene.cameras, iid, dtype, device)
    b = cm.bearing(*rows, torch.as_tensor(xy, dtype=dtype, device=device)).cpu().numpy()
    ofs = 0
    for r in recs:
        n = len(r["m"])
        r["ba"], r["bb"] = b[ofs:ofs + n], b[ofs + n:ofs + 2 * n]
        ofs += 2 * n
