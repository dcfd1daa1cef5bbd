"""Descriptor matching: brute-force L2 2-NN, the cascade-hashing Hamming
prefilter, brute-force Hamming, the host kd-tree, ratio test and dedupe
(counterpart: openmvg_tpu/ops/matching.py).

Reference parity: matching/ — metric.hpp L2, metric_hamming.hpp,
matcher_brute_force.hpp, matching_filters.hpp NNdistanceRatio (d1 < ratio^2
* d2 on squared distances, default 0.8), indMatch.hpp getDeduplicated,
cascade_hasher.hpp (hyperplane sign codes, Hamming ranking, exact L2 on
the best candidates), matcher_kdtree_flann.hpp (an exact kd-tree 2-NN).

The brute-force 2-NN is kernel K1 (ops/two_nn.py) for CUDA tensors and
its plain version for CPU tensors; uint8 distances are exact integers
either way, so matches are bit-identical to the reference's.  The cascade
needs no kernel of its own: its sign codes and Hamming matrix are products
of +-1 in float32 (exact below 2^24 bits), and its re-rank sums at most
top_c * 128 squared u8 differences (exact below 2^24).  Its candidate list
is exact: the top_c smallest Hamming distances with ties to the lowest
column, as the reference's approx_min_k gives on the CPU (on the TPU that
call is approximate).
"""

from typing import NamedTuple

import numpy as np
import torch

from openmvg_torch.ops.two_nn import (FLT_MAX, MAX_PAIRS, l2_distance_matrix,  # noqa: F401
                                      two_nn, two_nn_batch, two_nn_fused)

_INT64_MAX = torch.iinfo(torch.int64).max
DESC_DIM = 128
# device bytes of one batch of cascade pairs (the Hamming matrix, its
# candidate keys and the gathered candidates of every pair)
CASCADE_BATCH_BYTES = 1 << 32


def ratio_filter(d1, d2, ratio=0.8):
    """NNdistanceRatio on squared distances: d1 < ratio^2 * d2."""
    return d1 < (ratio * ratio) * d2


def dedupe_right(idx1, keep, d1, n_cols):
    """Keep only the best (smallest-distance) match per right index, ties to
    the lowest row (IndMatch dedupe).  idx1, keep, d1 (..., N) -> keep.

    Each kept row's key (float bits of d1 >= 0, row) is unique and orders
    as (distance, row); a scatter-min per right index picks the winner."""
    lead, N = idx1.shape[:-1], idx1.shape[-1]
    idx = idx1.reshape(-1, N).to(torch.int64)
    k = keep.reshape(-1, N)
    d = torch.where(d1 > 0, d1, torch.zeros_like(d1)).reshape(-1, N)
    rows = torch.arange(N, device=idx.device, dtype=torch.int64)
    key = (d.contiguous().view(torch.int32).to(torch.int64) << 32) | rows
    key = torch.where(k, key, torch.full_like(key, _INT64_MAX))
    best = torch.full((idx.shape[0], n_cols), _INT64_MAX, dtype=torch.int64,
                      device=idx.device)
    best.scatter_reduce_(1, idx, key, reduce="amin")
    win = k & (torch.gather(best, 1, idx) == key)
    return win.reshape(lead + (N,))


class MatchResult(NamedTuple):
    idx_a: torch.Tensor  # (..., N) row index
    idx_b: torch.Tensor  # (..., N) matched column per row
    mask: torch.Tensor   # (..., N) valid match flag
    dist: torch.Tensor   # (..., N) squared distance


def match_brute_force(desc_a, desc_b, valid_a=None, valid_b=None, ratio=0.8):
    """ArrayMatcherBruteForce + ratio + dedupe for one pair; desc (N|M, D)."""
    d1, d2, idx1 = two_nn_fused(desc_a, desc_b, valid_b)
    keep = ratio_filter(d1, d2, ratio)
    if valid_a is not None:
        keep = keep & valid_a
    keep = dedupe_right(idx1, keep, d1, desc_b.shape[0])
    return MatchResult(idx_a=torch.arange(desc_a.shape[0], device=desc_a.device),
                       idx_b=idx1, mask=keep, dist=d1)


def match_pair_batch(descs, counts, pair_ij, ratio=0.8, method="bruteforce", proj=None,
                     mean=None, top_c=16):
    """Match a batch of image pairs: descs (V, Nmax, D) padded stack, counts
    (V,) int32, pair_ij (P, 2) int32 -> MatchResult with leading (P, Nmax).
    method "bruteforce": on CUDA the whole batch is one K1 launch;
    "cascade": match_cascade on every pair at once (proj, mean needed)."""
    nmax = descs.shape[1]
    col = torch.arange(nmax, device=descs.device)
    pi, pj = pair_ij[:, 0].long(), pair_ij[:, 1].long()
    valid_a = col[None, :] < counts[pi][:, None]
    if method == "cascade":
        return match_cascade(descs[pi], descs[pj], proj, mean, valid_a,
                             col[None, :] < counts[pj][:, None], ratio=ratio, top_c=top_c)
    if method != "bruteforce":
        raise ValueError(f"unknown method {method}")
    d1, d2, idx1 = two_nn_batch(descs, counts, pair_ij)
    keep = ratio_filter(d1, d2, ratio) & valid_a
    keep = dedupe_right(idx1, keep, d1, nmax)
    return MatchResult(idx_a=col.expand(pair_ij.shape[0], nmax), idx_b=idx1,
                       mask=keep, dist=d1)


def descriptor_stack(descs, device):
    """List of (N_v, D) descriptor arrays -> ((V, Nmax, D) padded stack,
    (V,) int32 counts) on `device`; uint8 when every list is, else float32."""
    nmax = max(max((len(d) for d in descs), default=0), 1)
    dim = next((np.shape(d)[1] for d in descs if np.ndim(d) == 2), DESC_DIM)
    dt = np.uint8 if all(np.asarray(d).dtype == np.uint8 for d in descs) else np.float32
    stack = np.zeros((len(descs), nmax, dim), dt)
    counts = np.zeros(len(descs), np.int32)
    for v, d in enumerate(descs):
        stack[v, :len(d)] = d
        counts[v] = len(d)
    return torch.as_tensor(stack, device=device), torch.as_tensor(counts, device=device)


def match_descriptor_lists(descs, pairs, ratio=0.8, device="cuda", method="bruteforce",
                           proj=None, mean=None, top_c=16):
    """Matches of every pair of `pairs` over the descriptor lists `descs`:
    {(i, j): (M, 2) int64}.  "bruteforce": the descriptors go to `device`
    as one padded stack and each batch of up to MAX_PAIRS pairs is one K1
    launch on CUDA; "cascade": batches sized by CASCADE_BATCH_BYTES;
    "kdtree": match_kdtree pair by pair on the host."""
    if method == "kdtree":
        out = {}
        for i, j in pairs:
            m = match_kdtree(descs[i], descs[j], ratio=ratio)
            if len(m):
                out[(int(i), int(j))] = m
        return out
    stack, counts = descriptor_stack(descs, device)
    nmax, dim = stack.shape[1], stack.shape[2]
    step = MAX_PAIRS
    if method == "cascade":
        c = min(top_c, nmax)
        per_pair = 4 * nmax * (6 * nmax + 2 * c * dim)
        step = max(1, min(MAX_PAIRS, CASCADE_BATCH_BYTES // per_pair))
    out = {}
    for s in range(0, len(pairs), step):
        chunk = np.asarray(pairs[s:s + step], np.int32).reshape(-1, 2)
        res = match_pair_batch(stack, counts, torch.as_tensor(chunk, device=device),
                               ratio=ratio, method=method, proj=proj, mean=mean, top_c=top_c)
        out.update(matches_to_dict(chunk, res))
    return out


def matches_to_dict(pair_ij, result: MatchResult):
    """Batch result -> {(i, j): (M, 2) int64 numpy} PairWiseMatches."""
    out = {}
    pair_ij = np.asarray(pair_ij)
    mask = result.mask.cpu().numpy()
    idx_b = result.idx_b.cpu().numpy()
    for p in range(len(pair_ij)):
        sel = np.nonzero(mask[p])[0]
        if len(sel):
            out[(int(pair_ij[p, 0]), int(pair_ij[p, 1]))] = np.stack(
                [sel, idx_b[p][sel]], axis=1).astype(np.int64)
    return out


def preemptive_subset(feats, descs, k=200):
    """The k largest-scale features (main_ComputeMatches.cpp:55-57,
    sfm_preemptive_regions_provider.hpp:19)."""
    feats = np.asarray(feats)
    if len(feats) <= k:
        return feats, np.asarray(descs)
    order = np.argsort(-feats[:, 2], kind="stable")[:k]
    return feats[order], np.asarray(descs)[order]


# ---------------------------------------------------------------------------
# cascade hashing: Hamming prefilter, exact L2 re-rank
# ---------------------------------------------------------------------------

def make_hash_projections(seed=0, dim=DESC_DIM, bits=128, device="cpu"):
    """Random hyperplanes (CascadeHasher::Init primary hash): (dim, bits)
    standard normal float32, drawn on the host from a torch.Generator seeded
    `seed`, so every device gets the same planes.  They differ from the
    reference's jax.random draw (a test carries those across as
    tensors)."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.randn((dim, bits), generator=g, dtype=torch.float32).to(device)


def sign_codes(desc, proj, mean):
    """Zero-mean descriptors (..., N, D) -> (..., N, bits) +-1 float32 codes."""
    z = (desc.to(torch.float32) - mean) @ proj
    return torch.where(z >= 0, 1.0, -1.0).to(torch.float32)


def match_cascade(desc_a, desc_b, proj, mean, valid_a=None, valid_b=None, ratio=0.8,
                  top_c=16):
    """Hamming-prefiltered 2-NN (the CASCADEHASHINGL2 contract) on (..., N, D)
    and (..., M, D) descriptors, any leading batch shape:
      1. sign codes of both sides, the Hamming matrix (bits - s_a s_b^T) / 2;
      2. the top_c smallest Hamming distances of each row, ties to the
         lowest column (one key ham * M + col, unique per row);
      3. exact L2 on those candidates, the 2-NN in candidate order (a
         stable sort), ratio and dedupe.
    Invalid columns rank after every valid one and score FLT_MAX."""
    sa = sign_codes(desc_a, proj, mean)
    sb = sign_codes(desc_b, proj, mean)
    bits, M = proj.shape[1], desc_b.shape[-2]
    if (bits + 2) * M >= 2 ** 31:
        raise ValueError(f"{M} columns of {bits} bits: the candidate keys must fit int32")
    ham = ((bits - sa @ sb.transpose(-1, -2)) * 0.5).to(torch.int32)
    if valid_b is not None:
        ham = torch.where(valid_b[..., None, :], ham, bits + 1)
    key = ham * M + torch.arange(M, dtype=torch.int32, device=ham.device)
    c = min(top_c, M)
    cand = torch.topk(key, c, dim=-1, largest=False, sorted=True).indices   # (..., N, C)
    lead = cand.shape[:-2]
    b32 = desc_b.to(torch.float32).reshape((-1,) + desc_b.shape[-2:])
    cflat = cand.reshape(b32.shape[0], -1)
    bc = torch.gather(b32, 1, cflat[..., None].expand(-1, -1, b32.shape[-1]))
    bc = bc.reshape(cand.shape + (b32.shape[-1],))
    d = desc_a.to(torch.float32)[..., :, None, :] - bc
    dist = (d * d).sum(-1)                                              # (..., N, C)
    if valid_b is not None:
        vb = torch.gather(valid_b.reshape(b32.shape[0], M), 1, cflat).reshape(cand.shape)
        dist = torch.where(vb, dist, FLT_MAX)
    srt, order = torch.sort(dist, dim=-1, stable=True)
    d1 = srt[..., 0]
    d2 = srt[..., 1] if c > 1 else torch.full_like(d1, FLT_MAX)
    idx1 = torch.gather(cand, -1, order[..., :1])[..., 0]
    keep = ratio_filter(d1, d2, ratio)
    if valid_a is not None:
        keep = keep & valid_a
    keep = dedupe_right(idx1, keep, d1, M)
    N = desc_a.shape[-2]
    return MatchResult(idx_a=torch.arange(N, device=d1.device).expand(lead + (N,)),
                       idx_b=idx1, mask=keep, dist=d1)


# ---------------------------------------------------------------------------
# brute-force Hamming on packed binary descriptors, and the host kd-tree
# ---------------------------------------------------------------------------

def _unpack_bits_pm1(packed):
    """(..., N, B) uint8 -> (..., N, 8B) +-1 float32 sign codes, low bit first."""
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                           device=packed.device)
    bits = (packed[..., :, None] & weights) > 0
    return torch.where(bits, 1.0, -1.0).to(torch.float32).reshape(packed.shape[:-1] + (-1,))


def match_brute_force_hamming(desc_a, desc_b, valid_a=None, valid_b=None, ratio=0.8):
    """Brute-force Hamming 2-NN of packed binary descriptors (metric_hamming.hpp):
    hamming = (bits - s_a . s_b) / 2 from one float32 product of sign codes,
    exact below 2^24 bits.  Hamming distances are linear, so the ratio
    applies to them directly (d1 < ratio * d2).  desc (..., N|M, B): any
    leading dimensions are a batch of pairs."""
    sa = _unpack_bits_pm1(desc_a)
    sb = _unpack_bits_pm1(desc_b)
    ham = (sa.shape[-1] - sa @ sb.transpose(-1, -2)) * 0.5
    d1, d2, idx1 = two_nn(ham, valid_b)
    keep = d1 < ratio * d2
    if valid_a is not None:
        keep = keep & valid_a
    keep = dedupe_right(idx1, keep, d1, desc_b.shape[-2])
    idx_a = torch.arange(desc_a.shape[-2], device=desc_a.device).expand(keep.shape)
    return MatchResult(idx_a=idx_a, idx_b=idx1, mask=keep, dist=d1)


def match_kdtree(desc_a, desc_b, ratio=0.8):
    """Exact kd-tree 2-NN on the host (matcher_kdtree_flann.hpp:34, scipy's
    cKDTree for FLANN), with the ratio on squared distances and the
    best-per-right-index dedupe, lowest row on ties.  Returns (M, 2) int64."""
    from scipy.spatial import cKDTree

    a = np.asarray(desc_a, np.float32)
    b = np.asarray(desc_b, np.float32)
    if len(a) == 0 or len(b) < 2:
        return np.zeros((0, 2), np.int64)
    d, idx = cKDTree(b).query(a, k=2)
    d1, d2 = d[:, 0] ** 2, d[:, 1] ** 2
    keep = d1 < (ratio * ratio) * d2
    idx1 = idx[:, 0]
    order = np.lexsort((np.arange(len(a)), d1))
    seen = np.zeros(len(b), bool)
    rows = []
    for r in order:
        if keep[r] and not seen[idx1[r]]:
            seen[idx1[r]] = True
            rows.append(r)
    rows = np.sort(np.asarray(rows, np.int64))
    return np.stack([rows, idx1[rows]], 1) if len(rows) else np.zeros((0, 2), np.int64)
