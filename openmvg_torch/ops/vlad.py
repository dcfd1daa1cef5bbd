"""K-means clustering and VLAD image-retrieval embeddings (counterpart:
openmvg_tpu/ops/vlad.py).

Reference parity: clustering/kmeans.hpp (Lloyd iterations, k-means++
seeding, KMeansInitType:29) and matching_image_collection/VladBase.hpp:38-77
(residuals to the assigned centre summed per cluster, intra- then global L2
normalisation); main_ComputeVLAD.cpp retrieves pairs from them.

Every per-cluster sum goes through ops/seg_sum.py::seg_sum, kernel K2 on
the card (its plain version on the CPU), where the reference calls
jax.ops.segment_sum.  K2 takes at most 64 columns, so a 128-wide sum is two
calls of 64 that share one plan of the assignments.  K2 sums in a fixed
order without float atomics, so the codebook repeats bit for bit.  The
distances are plain matmuls (float32, TF32 off), as in the reference.

The k-means++ seeding draws from a torch.Generator, not jax.random, so the
port's codebook differs from the reference's unless the reference's
initial centres are carried across as a tensor.
"""

import numpy as np
import torch

from openmvg_torch.ops import seg_sum as ss
from openmvg_torch.ops.two_nn import l2_distance_matrix


def kmeans_pp_init(generator, X, k):
    """k-means++ seeding (KMEANS_PLUS_PLUS): X (N, D) float -> (k, D).
    The uniforms come from `generator` (a CPU torch.Generator), so the
    draws are the same on every device; each index is the first whose
    cumulative weight passes its uniform."""
    n = X.shape[0]
    u = torch.rand(k, generator=generator, dtype=torch.float64)
    idx = min(int(u[0] * n), n - 1)
    centers = [X[idx]]
    d2 = ((X - centers[0]) ** 2).sum(-1)
    for i in range(1, k):
        cdf = torch.cumsum(d2.to(torch.float64), 0)
        t = (u[i] * cdf[-1]).to(cdf.device)
        idx = min(int(torch.searchsorted(cdf, t[None], right=True)[0]), n - 1)
        c = X[idx]
        centers.append(c)
        d2 = torch.minimum(d2, ((X - c) ** 2).sum(-1))
    return torch.stack(centers)


def nearest_center(X, centers):
    """(N,) index of the nearest centre of every row (argmin, first on ties)."""
    return torch.argmin(l2_distance_matrix(X, centers), dim=-1)


def cluster_sums(vals, ids, num, plan=None):
    """(O, D) rows summed by id into (num, D) through K2 (seg_sum), in
    blocks of at most 64 columns that share one plan."""
    if vals.device.type == "cuda" and plan is None:
        plan = ss.seg_sum_plan(ids, num)
    return torch.cat([ss.seg_sum(vals[:, c:c + ss.MAX_K].contiguous(), ids, num, plan)
                      for c in range(0, vals.shape[1], ss.MAX_K)], dim=1)


def _lloyd(X, centers, n_iter=25):
    k = centers.shape[0]
    for _ in range(n_iter):
        assign = nearest_center(X, centers)
        sums = cluster_sums(X, assign, k)
        counts = torch.bincount(assign, minlength=k).to(X.dtype)[:, None]
        centers = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), centers)
    return centers, nearest_center(X, centers)


def kmeans(generator, X, k, n_iter=25):
    """Returns (centers (k, D), assignments (N,)) for X (N, D) on its device."""
    X = X.to(torch.float32)
    return _lloyd(X, kmeans_pp_init(generator, X, k), n_iter=n_iter)


def build_codebook(generator, descriptors, k=128, max_samples=100000, device="cuda"):
    """Codebook (k, D) numpy float32 from a pooled descriptor sample
    (main_ComputeVLAD); above max_samples rows, the reference's numpy
    subsample (default_rng(0))."""
    X = np.asarray(descriptors, np.float32)
    if len(X) > max_samples:
        X = X[np.random.default_rng(0).choice(len(X), max_samples, replace=False)]
    centers, _ = kmeans(generator, torch.as_tensor(X, device=device), k)
    return centers.cpu().numpy()


def vlad_from_assign(desc, centers, assign, view, n_views):
    """VLAD vectors (n_views, k * D) from descriptors (N, D) of all views,
    their centres' indices `assign` and their views `view` (N,): residuals
    summed per (view, cluster), each cluster's sum L2-normalised, then each
    vector.  The sums run in the dtype of `desc` on its device."""
    k, D = centers.shape
    resid = desc - centers[assign]
    agg = cluster_sums(resid, view.long() * k + assign, n_views * k).reshape(n_views, k, D)
    agg = agg / torch.clamp(torch.linalg.vector_norm(agg, dim=-1, keepdim=True), min=1e-12)
    v = agg.reshape(n_views, k * D)
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


def vlad_embeddings(descs, centers, device="cuda"):
    """VLAD vectors (V, k * D) float32 of a list of per-view descriptor
    arrays: every view's sums in one K2 call a 64-column block."""
    c = torch.as_tensor(np.asarray(centers, np.float32), device=device)
    desc = torch.as_tensor(np.concatenate([np.asarray(d, np.float32).reshape(-1, c.shape[1])
                                           for d in descs]), device=device)
    view = torch.as_tensor(np.repeat(np.arange(len(descs)), [len(d) for d in descs]),
                           device=device)
    return vlad_from_assign(desc, c, nearest_center(desc, c), view, len(descs))


def vlad_embedding(desc, centers):
    """VLAD vector (k * D,) of one image: desc (N, D), centers (k, D) tensors."""
    desc = desc.to(torch.float32)
    view = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    return vlad_from_assign(desc, centers, nearest_center(desc, centers), view, 1)[0]


def retrieve_pairs(vlads, top_k=10):
    """The top_k most similar images of every image, from stacked VLADs
    (V, kD) float32: sorted (i, j) pairs with i < j.  Ties go to the lower
    index, as the reference's top_k does."""
    V = torch.as_tensor(np.asarray(vlads, np.float32))
    sim = V @ V.T - 2.0 * torch.eye(V.shape[0])
    k = min(top_k, V.shape[0] - 1)
    idx = torch.sort(sim, dim=-1, descending=True, stable=True).indices[:, :k].numpy()
    return sorted({(min(i, int(j)), max(i, int(j))) for i in range(len(idx)) for j in idx[i]})
