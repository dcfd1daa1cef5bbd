"""Batched a-contrario RANSAC (counterpart: openmvg_tpu/ops/ransac.py).

Reference parity: robust_estimation/robust_estimator_ACRansac.hpp —
NFA(k) = log10(e0) + logalpha(e_k)*(k - s) + log10 C(n, k) + log10 C(k, s)
minimised over k (:269-306), logalpha = logalpha0 + multError*log10(e_k),
loge0 = log10(MAX_MODELS * (n - s)).

All minimal samples are drawn up front, solved as one batch, and every
model's residuals are scored with one sort and a cumulative NFA scan; a
second round resamples from the best model's inliers (the reference's
iteration reserve, :366-368).  Every tensor carries a leading batch
dimension B (one estimation problem per row, e.g. one image pair).

Random draws: minimal samples are the top-k of Gumbel noise plus log
weights.  The noise comes from one torch.Generator per batch row, or from
a precomputed table, so tests can hand the reference the same draws.
The arithmetic runs in the dtype of the data (float32 on the card,
float64 in the parity tests).
"""

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

_LN10 = math.log(10.0)
_F32EPS = float(np.finfo(np.float32).eps)


class ACRansacResult(NamedTuple):
    model: Any                 # (B, ...) best model per row
    inliers: torch.Tensor      # (B, N) bool
    nfa: torch.Tensor          # (B,) log10-NFA (< 0 is meaningful)
    threshold_sq: torch.Tensor  # (B,) squared residual threshold
    found: torch.Tensor        # (B,) bool


def log10_comb(n, k, dtype=torch.float64):
    """log10 C(n, k) elementwise via lgamma in `dtype`; +inf outside
    0 <= k <= n."""
    dev = n.device if torch.is_tensor(n) else (
        k.device if torch.is_tensor(k) else None)
    n = torch.as_tensor(n, device=dev).to(dtype)
    k = torch.as_tensor(k, device=dev).to(dtype)
    out = (torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0)
           - torch.lgamma(n - k + 1.0)) / _LN10
    return torch.where((k >= 0) & (k <= n), out, torch.full_like(out, math.inf))


def gumbel_table(generators, n_samples, n, dtype, device):
    """One (n_samples, n) table of standard Gumbel noise per generator,
    stacked -> (len(generators), n_samples, n)."""
    return torch.stack([
        -torch.empty((n_samples, n), dtype=dtype, device=device)
        .exponential_(generator=g).log() for g in generators])


def draw_samples(generator, n_samples, sample_size, weights, gumbel=None):
    """(B, n_samples, sample_size) distinct indices drawn ~ weights (B, N).

    Gumbel top-k: one top-k per sample, no rejection.  `generator` is a
    list of B torch.Generators (one stream per row); `gumbel`, when given,
    is the (B, n_samples, N) noise table and the generators are not used."""
    B, N = weights.shape
    if gumbel is None:
        gumbel = gumbel_table(generator, n_samples, N, weights.dtype,
                              weights.device)
    logw = torch.where(weights > 0, torch.log(torch.clamp(weights, min=1e-30)),
                       torch.full_like(weights, -math.inf))
    return torch.topk(gumbel + logw[:, None, :], sample_size, dim=-1).indices


def _nfa_scan(err_sq, n_valid, min_samples, logalpha0, mult_error, loge0,
              max_threshold_sq):
    """Best (nfa, threshold) over all k for each model's residual row.

    err_sq (B, R, N) squared residuals (+inf on invalid points); n_valid,
    logalpha0, loge0, max_threshold_sq (B,).  Returns nfa, thr_sq (B, R)."""
    B, R, N = err_sq.shape
    err_sorted = torch.sort(err_sq, dim=-1).values
    k = torch.arange(1, N + 1, dtype=err_sq.dtype, device=err_sq.device)
    logalpha = logalpha0[:, None, None] + mult_error * torch.log10(err_sorted + _F32EPS)
    lc = (log10_comb(n_valid[:, None], k[None, :], k.dtype)
          + log10_comb(k, float(min_samples), k.dtype)[None])
    nfa_k = loge0[:, None, None] + logalpha * (k - min_samples) + lc[:, None, :]
    nv = n_valid.to(k.dtype)[:, None, None]
    ok = ((k > min_samples) & (k <= nv) & (err_sorted <= max_threshold_sq[:, None, None])
          & torch.isfinite(err_sorted))
    nfa_k = torch.where(ok, nfa_k, torch.full_like(nfa_k, math.inf))
    best_k = torch.argmin(nfa_k, dim=-1, keepdim=True)
    nfa = torch.gather(nfa_k, -1, best_k)[..., 0]
    thr = torch.gather(err_sorted, -1, best_k)[..., 0]
    return nfa, thr


def tree_map(fn, *trees):
    """fn over a model that is one tensor or a tuple of tensors (P3P's
    (R, t), a NamedTuple such as a Plane), leaf by leaf."""
    if isinstance(trees[0], (tuple, list)):
        out = [fn(*leaves) for leaves in zip(*trees)]
        return trees[0]._make(out) if hasattr(trees[0], "_make") else type(trees[0])(out)
    return fn(*trees)


def _round(fit_fn, error_fn, data, valid, weights, min_samples, n_samples,
           logalpha0, mult_error, loge0, max_threshold_sq, generators, gumbel):
    idx = draw_samples(generators, n_samples, min_samples, weights, gumbel)
    B = idx.shape[0]
    rows = torch.arange(B, device=idx.device)
    sub = tuple(d[rows[:, None, None], idx] for d in data)
    models, mvalid = fit_fn(sub)                  # (B, S, M, ...), (B, S, M)
    flat = tree_map(lambda m: m.reshape((B, -1) + m.shape[3:]), models)
    mvalid = mvalid.reshape(B, -1)
    err = error_fn(flat, data)                    # (B, S*M, N)
    ok = valid[:, None, :] & mvalid[:, :, None] & ~torch.isnan(err)
    err = torch.where(ok, err, torch.full_like(err, math.inf))
    nfa, thr = _nfa_scan(err, valid.sum(-1), min_samples, logalpha0,
                         mult_error, loge0, max_threshold_sq)
    best = torch.argmin(nfa, dim=-1)
    return (tree_map(lambda m: m[rows, best], flat), nfa[rows, best],
            thr[rows, best], err[rows, best])


def _select(cond, a, b):
    """Per-row where over a model tree: a where cond (B,), else b."""
    return tree_map(lambda x, y: torch.where(
        cond.reshape((-1,) + (1,) * (x.dim() - 1)), x, y), a, b)


def ac_ransac(generators, fit_fn: Callable, error_fn: Callable, data, valid,
              min_samples: int, logalpha0, mult_error: float,
              max_models: int = 1, n_samples: int = 1024,
              precision_sq=math.inf, gumbel=None) -> ACRansacResult:
    """Batched AC-RANSAC.

    data: tuple of (B, N, ...) tensors; valid (B, N) bool.  fit_fn maps a
    tuple of (B, S, min_samples, ...) samples to (models (B, S, M, ...),
    model_valid (B, S, M)); a model is a tensor or a tuple of tensors.
    error_fn maps (models (B, R, ...), data) to squared residuals
    (B, R, N).  logalpha0 and precision_sq are scalars
    or (B,).  n_samples is split 90/10 between the global round and the
    inlier-resampling round.  gumbel: optional (B, s1 + s2, N) noise table,
    rows [0, s1) for the first round and [s1, s1 + s2) for the second.
    """
    dt, dev = data[0].dtype, data[0].device
    B = valid.shape[0]
    n_valid = valid.sum(-1)
    # log10(e0) in float32, as the reference computes it
    loge0 = torch.log10(torch.clamp(
        max_models * (n_valid.to(torch.float32) - min_samples), min=1.0)).to(dt)
    logalpha0 = torch.as_tensor(logalpha0, dtype=dt, device=dev).expand(B)
    prec = torch.as_tensor(precision_sq, dtype=dt, device=dev).expand(B)
    uni = valid.to(dt)
    s1 = max(n_samples * 9 // 10, 1)
    s2 = max(n_samples - s1, 1)
    g1 = g2 = None
    if gumbel is not None:
        if gumbel.shape[1] < s1 + s2:
            raise ValueError(f"gumbel table has {gumbel.shape[1]} rows, needs {s1 + s2}")
        g1, g2 = gumbel[:, :s1], gumbel[:, s1:s1 + s2]

    m1, nfa1, thr1, err1 = _round(fit_fn, error_fn, data, valid, uni, min_samples,
                                  s1, logalpha0, mult_error, loge0, prec,
                                  generators, g1)
    inl_w = ((err1 <= thr1[:, None]) & valid).to(dt)
    enough = inl_w.sum(-1) > min_samples
    inl_w = torch.where(enough[:, None], inl_w, uni)
    m2, nfa2, thr2, err2 = _round(fit_fn, error_fn, data, valid, inl_w,
                                  min_samples, s2, logalpha0, mult_error, loge0,
                                  prec, generators, g2)
    pick2 = nfa2 < nfa1
    model = _select(pick2, m2, m1)
    nfa = torch.where(pick2, nfa2, nfa1)
    thr = torch.where(pick2, thr2, thr1)
    err = torch.where(pick2[:, None], err2, err1)
    inliers = (err <= thr[:, None]) & valid
    found = (nfa < 0) & (inliers.sum(-1) > min_samples)
    return ACRansacResult(model=model, inliers=inliers, nfa=nfa,
                          threshold_sq=thr, found=found)


def ac_ransac_adaptive(generators, fit_fn: Callable, error_fn: Callable, data,
                       valid, min_samples: int, logalpha0, mult_error: float,
                       max_models: int = 1, round_size: int = 256,
                       max_rounds: int = 16, reserve_rounds: int = 2,
                       precision_sq=math.inf, gumbel=None):
    """Adaptive-budget AC-RANSAC (counterpart: openmvg_tpu/ops/ransac.py
    ac_ransac_adaptive; robust_estimator_ACRansac.hpp:326-489 early exit):
    rounds of round_size samples until max_rounds, or until reserve_rounds
    rounds past the first meaningful model; once a row has one, its next
    rounds resample from that model's inliers.  Each batch row keeps its
    own state and stops on its own; the loop ends when every row has.

    gumbel: optional (B, max_rounds * round_size, N) noise table, round r
    taking rows [r * round_size, (r + 1) * round_size).
    Returns (ACRansacResult, n_rounds (B,) int64)."""
    dt, dev = data[0].dtype, data[0].device
    B = valid.shape[0]
    n_valid = valid.sum(-1)
    loge0 = torch.log10(torch.clamp(
        max_models * (n_valid.to(torch.float32) - min_samples), min=1.0)).to(dt)
    logalpha0 = torch.as_tensor(logalpha0, dtype=dt, device=dev).expand(B)
    prec = torch.as_tensor(precision_sq, dtype=dt, device=dev).expand(B)
    uni = valid.to(dt)

    def table(r):
        return None if gumbel is None else gumbel[:, r * round_size:(r + 1) * round_size]

    model, nfa, thr, err = _round(fit_fn, error_fn, data, valid, uni, min_samples,
                                  round_size, logalpha0, mult_error, loge0, prec,
                                  generators, table(0))
    found_it = torch.where(nfa < 0, 0, max_rounds).to(torch.int64)
    it = torch.ones(B, dtype=torch.int64, device=dev)
    for r in range(1, max_rounds):
        active = (it < max_rounds) & ((nfa >= 0) | (it <= found_it + reserve_rounds))
        if not bool(active.any()):
            break
        inl_w = ((err <= thr[:, None]) & valid).to(dt)
        enough = (nfa < 0) & (inl_w.sum(-1) > min_samples)
        w = torch.where(enough[:, None], inl_w, uni)
        m2, nfa2, thr2, err2 = _round(fit_fn, error_fn, data, valid, w, min_samples,
                                      round_size, logalpha0, mult_error, loge0, prec,
                                      generators, table(r))
        better = active & (nfa2 < nfa)
        model = _select(better, m2, model)
        found_it = torch.where(active & (nfa >= 0) & (nfa2 < 0), it, found_it)
        thr = torch.where(better, thr2, thr)
        err = torch.where(better[:, None], err2, err)
        nfa = torch.where(active, torch.minimum(nfa, nfa2), nfa)
        it = it + active.to(torch.int64)
    inliers = (err <= thr[:, None]) & valid
    found = (nfa < 0) & (inliers.sum(-1) > min_samples)
    return ACRansacResult(model=model, inliers=inliers, nfa=nfa,
                          threshold_sq=thr, found=found), it


# logalpha0 helpers (ACParametrizationHelper, ACRansacKernelAdaptator.hpp:44-97)

def logalpha0_point_to_line(w, h, scaling=1.0, dtype=torch.float64):
    w = torch.as_tensor(w, dtype=dtype)
    h = torch.as_tensor(h, dtype=dtype)
    return torch.log10(2.0 * torch.hypot(w, h) / (w * h) / scaling)


def logalpha0_point_to_point(w, h, scaling=1.0, dtype=torch.float64):
    w = torch.as_tensor(w, dtype=dtype)
    h = torch.as_tensor(h, dtype=dtype)
    return torch.log10(math.pi / (w * h) / (scaling * scaling))


LOGALPHA0_ANGULAR = math.log10(0.5)
MULT_ERROR_POINT_TO_LINE = 0.5
MULT_ERROR_POINT_TO_POINT = 1.0
MULT_ERROR_ANGULAR = 0.25


# ---------------------------------------------------------------------------
# classic estimators (robust_estimator_{MaxConsensus,LMeds}.hpp): one
# problem, every minimal sample solved and scored in one batch
# ---------------------------------------------------------------------------

def _score_all(generator, fit_fn, error_fn, data, valid, min_samples, n_samples, idx):
    """Draw (or take) n_samples minimal samples, fit them all and score every
    model on every point.  data: tuple of (N, ...) tensors; fit_fn maps a
    tuple of (S, s, ...) samples to (models (S, M, ...), ok (S, M)); error_fn
    maps (models (R, ...), data) to squared residuals (R, N).  idx, when
    given, is the (S, s) sample table and the generator is not used.
    Returns (flat models (R, ...), model ok (R,), err (R, N), +inf where
    the point or the model is invalid)."""
    if idx is None:
        idx = draw_samples([generator], n_samples, min_samples,
                           valid.to(data[0].dtype)[None])[0]
    idx = torch.as_tensor(idx, device=valid.device).long()
    models, mvalid = fit_fn(tuple(d[idx] for d in data))
    flat = tree_map(lambda m: m.reshape((-1,) + m.shape[2:]), models)
    mvalid = mvalid.reshape(-1)
    err = error_fn(flat, data)
    ok = valid[None, :] & mvalid[:, None] & ~torch.isnan(err)
    return flat, mvalid, torch.where(ok, err, torch.full_like(err, math.inf))


def max_consensus(generator, fit_fn, error_fn, data, valid, min_samples, threshold_sq,
                  n_samples=1024, idx=None):
    """Plain max-consensus RANSAC (robust_estimator_MaxConsensus.hpp):
    the model with the most residuals <= threshold_sq (the first on ties).
    Returns (model, inliers (N,) bool, score)."""
    flat, _, err = _score_all(generator, fit_fn, error_fn, data, valid, min_samples,
                              n_samples, idx)
    score = (err <= threshold_sq).sum(-1)
    best = int(torch.argmax(score))
    return (tree_map(lambda a: a[best], flat), (err[best] <= threshold_sq) & valid,
            int(score[best]))


def lmeds(generator, fit_fn, error_fn, data, valid, min_samples, n_samples=1024, idx=None):
    """Least median of squares (robust_estimator_LMeds.hpp): the model whose
    k-th smallest residual, k = n_valid // 2, is least.  Returns (model,
    that median)."""
    flat, mvalid, err = _score_all(generator, fit_fn, error_fn, data, valid, min_samples,
                                   n_samples, idx)
    k = int(valid.sum()) // 2
    med = torch.sort(err, dim=-1).values[:, k]
    med = torch.where(mvalid, med, torch.full_like(med, math.inf))
    best = int(torch.argmin(med))
    return tree_map(lambda a: a[best], flat), med[best]
