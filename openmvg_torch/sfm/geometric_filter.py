"""Collection geometric filtering of putative matches, batched over pairs
(counterpart: openmvg_tpu/sfm/geometric_filter.py, models "f" and "e").

Reference parity: matching_image_collection/GeometricFilter.hpp
Robust_model_estimation (:31-63) with the F and E AC-RANSAC functors
(F_ACRobust.hpp:89, E_ACRobust.hpp; main_GeometricFilter.cpp:165-368):
per pair, AC-RANSAC with an upper-bound precision (4 px default, 2048
iterations); a pair is kept when a meaningful model has more than
2.5 x MIN_SAMPLES inliers, and only its inlier matches are kept.  Model
"e" takes unit bearings of every correspondence from one device call and
each pair's K matrices, and runs in float64 (the 5-point roots are fragile
in float32, as in the engines).

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
from openmvg_torch.sfm import robust

MIN_SAMPLES = {"f": 7, "e": 5, "h": 4, "a": 8, "u": 3, "o": 3}
_MAX_MODELS = {"f": 3, "e": 10}   # 7-point and 5-point solver roots
_BATCH_ELEMENTS = 1 << 27     # residual-table entries per batch


def pair_generator(seed, pos, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) * (1 << 32) + int(pos))
    return g


def geometric_filter(scene, features: List[np.ndarray],
                     matches: Dict[Tuple[int, int], np.ndarray],
                     model: str = "f", threshold_px: float = None,
                     n_samples: int = 2048, seed: int = 0,
                     guided: bool = False, device="cuda",
                     dtype=None) -> Dict[Tuple[int, int], np.ndarray]:
    """Filter putative matches with the fundamental ("f") or essential
    ("e") model.  dtype None is float32 for "f" and float64 for "e".

    Models h/a/u/o and guided matching come with later slices of the port
    and raise NotImplementedError here."""
    if model not in MIN_SAMPLES:
        raise ValueError(f"unknown model {model}")
    if model not in _MAX_MODELS:
        raise NotImplementedError(
            f"geometric model {model!r} is not ported yet; 'f' and 'e' are "
            "(ROADMAP queue 1, item 5: h/a/u/o later)")
    if guided:
        raise NotImplementedError(
            "guided matching (-r) needs sfm/known_poses.py, which comes with "
            "a later slice of the port")
    if threshold_px is None:
        threshold_px = 4.0
    if dtype is None:
        dtype = torch.float32 if model == "f" else torch.float64
    prec = threshold_px * threshold_px if np.isfinite(threshold_px) else np.inf
    s_min = MIN_SAMPLES[model]

    recs = []
    for pos, ((va, vb), m) in enumerate(sorted(matches.items())):
        m = np.asarray(m)
        if len(m) <= s_min:
            continue
        recs.append(dict(pos=pos, va=int(va), vb=int(vb), m=m,
                         xa=features[va][m[:, 0], :2],
                         xb=features[vb][m[:, 1], :2]))
    recs.sort(key=lambda r: len(r["m"]))
    if model == "e" and recs:
        _bearings_of(scene, recs, dtype, device)

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

    out = {}
    for grp in batches:
        n_max = len(grp[-1]["m"])
        P = len(grp)
        xa = np.zeros((P, n_max, 2))
        xb = np.zeros((P, n_max, 2))
        ba_ = np.zeros((P, n_max, 3))
        bb_ = np.zeros((P, n_max, 3))
        valid = np.zeros((P, n_max), bool)
        gumbel = torch.full((P, n_draws, n_max), -float("inf"), dtype=dtype,
                            device=device)
        for i, r in enumerate(grp):
            n = len(r["m"])
            xa[i, :n], xb[i, :n], valid[i, :n] = r["xa"], r["xb"], True
            if model == "e":
                ba_[i, :n], bb_[i, :n] = r["ba"], r["bb"]
            gumbel[i, :, :n] = ransac.gumbel_table(
                [pair_generator(seed, r["pos"], device)], n_draws, n, dtype,
                device)[0]
        wh_a = np.asarray([scene.view_wh[r["va"]] for r in grp], np.float64)
        wh_b = np.asarray([scene.view_wh[r["vb"]] for r in grp], np.float64)

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        valid_t = torch.as_tensor(valid, device=device)
        if model == "f":
            res = robust.robust_fundamental_batch(
                None, t(xa), t(xb), valid_t, t(wh_a[:, 0]), t(wh_a[:, 1]), t(wh_b[:, 0]),
                t(wh_b[:, 1]), n_samples=n_samples, precision_sq=prec, gumbel=gumbel)
        else:
            K_all = cm.K_matrix_np(np.asarray(scene.cameras.params, np.float64))
            Ka = np.stack([K_all[scene.view_intrinsic[r["va"]]] for r in grp])
            Kb = np.stack([K_all[scene.view_intrinsic[r["vb"]]] for r in grp])
            res = robust.robust_essential_batch(
                None, t(ba_), t(bb_), t(xa), t(xb), t(Ka), t(Kb), valid_t, t(wh_b[:, 0]),
                t(wh_b[:, 1]), n_samples=n_samples, precision_sq=prec, gumbel=gumbel)
        found = res.found.cpu().numpy()
        inliers = res.inliers.cpu().numpy()
        for i, r in enumerate(grp):
            inl = inliers[i, :len(r["m"])]
            if found[i] and inl.sum() > 2.5 * s_min:
                out[(r["va"], r["vb"])] = r["m"][inl]
    return {p: out[p] for p in sorted(out)}


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
