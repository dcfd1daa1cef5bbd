"""Ring-streamed all-pairs descriptor matching over a mesh of ranks
(counterpart: openmvg_tpu/parallel/ring_matching.py).

Each rank owns V/n views' descriptors.  At ring step s every rank matches
its local views against the resident block of views in one K1 launch
(ops/matching.py::match_pair_batch over the local and resident stacks side
by side, with its ratio test and de-duplication), then passes the block on
to the next rank and takes the previous rank's.  After n steps every
(local view, any view) pair has met, while a rank held 2/n of the
descriptors.  Only (a, b) pairs with a < b are wanted (the openMVG pair
list convention), so a rank matches a block only when its owner is not
below it, and in its own block only the pairs a < b: the (b, a) half of the
sweep is skipped, as in the reference.

Transport: under NCCL the block and its counts go to the next rank with
dist.batch_isend_irecv on the device.  gloo's send and recv take only CPU
tensors, so under gloo a CUDA block is staged through a host buffer (a
copy to the host, the exchange, a copy back to the card), explicitly here.

Memory a rank: O(2 V/n Nmax D) descriptors instead of O(V Nmax D).
"""

import numpy as np
import torch
import torch.distributed as dist

from openmvg_torch.ops import matching
from openmvg_torch.ops.two_nn import MAX_PAIRS
from openmvg_torch.parallel import mesh as meshlib


def _pass_on(blocks, mesh):
    """Send `blocks` to the next rank of the ring and return the previous
    rank's (host-staged under gloo)."""
    n = mesh.size
    nxt = mesh.ranks[(mesh.rank + 1) % n]
    prv = mesh.ranks[(mesh.rank - 1) % n]
    stage = dist.get_backend(mesh.group) == "gloo"
    sends = [b.cpu() if stage else b.contiguous() for b in blocks]   # host buffers
    recvs = [torch.empty_like(b) for b in sends]
    ops = [dist.P2POp(dist.isend, s, nxt, mesh.group) for s in sends] + \
          [dist.P2POp(dist.irecv, r, prv, mesh.group) for r in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(b.device) for r, b in zip(recvs, blocks)]


def _block_pairs(Vl, diagonal, device):
    """(a, b) local x resident view pairs of one block: all of them, or
    those with a < b in the rank's own block."""
    a, b = torch.meshgrid(torch.arange(Vl, device=device), torch.arange(Vl, device=device),
                          indexing="ij")
    a, b = a.reshape(-1), b.reshape(-1)
    if diagonal:
        keep = a < b
        a, b = a[keep], b[keep]
    return a, b


def ring_sweep(local_d, local_c, mesh, ratio=0.8):
    """The ring on this rank: yields (owner, a, b, MatchResult) for each
    block matched, a and b the local and resident view indices within their
    shards (owner's shard for b).  One K1 launch a matched block."""
    n, me = mesh.size, mesh.rank
    Vl = local_d.shape[0]
    blocks, owner = [local_d, local_c], me
    for s in range(n):
        if owner >= me:
            a, b = _block_pairs(Vl, owner == me, local_d.device)
            stack = torch.cat([local_d, blocks[0]])
            counts = torch.cat([local_c, blocks[1]])
            pairs = torch.stack([a, Vl + b], 1).to(torch.int32)
            for k in range(0, len(a), MAX_PAIRS):
                res = matching.match_pair_batch(stack, counts, pairs[k:k + MAX_PAIRS],
                                                ratio=ratio)
                yield owner, a[k:k + MAX_PAIRS], b[k:k + MAX_PAIRS], res
        if s < n - 1:
            blocks = _pass_on(blocks, mesh)
            owner = (owner - 1) % n


def ring_all_pairs_match(descs, counts, mesh, ratio=0.8):
    """All-pairs brute-force matching with ring-sharded descriptors.

    descs (V, Nmax, D) uint8|float32 and counts (V,), the same on every
    rank (host tensors); V a multiple of the mesh size.  Returns this
    rank's rows (idx_b, mask, dist), each (V/n, V, Nmax), on its device:
    entry [a, b] matches local view a against view b.  Only pairs with
    a < b are matched; the others are zeros (mask False)."""
    n = mesh.size
    V, Nmax, _ = descs.shape
    if V % n:
        raise ValueError(f"V={V} not a multiple of mesh size {n}")
    Vl = V // n
    local_d = meshlib.shard_rows(descs, mesh)
    local_c = meshlib.shard_rows(counts.to(torch.int32), mesh)
    dev = local_d.device
    idx = torch.zeros((Vl, V, Nmax), dtype=torch.int32, device=dev)
    mask = torch.zeros((Vl, V, Nmax), dtype=torch.bool, device=dev)
    dist_ = torch.zeros((Vl, V, Nmax), dtype=torch.float32, device=dev)
    for owner, a, b, res in ring_sweep(local_d, local_c, mesh, ratio):
        col = owner * Vl + b
        idx[a, col] = res.idx_b
        mask[a, col] = res.mask
        dist_[a, col] = res.dist
    return idx, mask, dist_


def ring_match_pairs(descs, counts, pair_ij, mesh, ratio=0.8):
    """match_pair_batch over a pair list, backed by the ring sweep, for
    descriptor stacks too large to hold whole on each rank (the CLI's
    `matches --ring_matching`).  descs, counts and pair_ij (rows i < j) are
    the same host tensors on every rank; V is padded to a multiple of the
    mesh size with empty views.  Returns, on mesh rank 0, the MatchResult
    (P, Nmax) on its device, identical to match_pair_batch(...,
    method="bruteforce") on the same pairs; None on the other ranks."""
    n = mesh.size
    V, Nmax, D = descs.shape
    pair_ij = torch.as_tensor(np.asarray(pair_ij, np.int64).reshape(-1, 2))
    if len(pair_ij) and not bool((pair_ij[:, 0] < pair_ij[:, 1]).all()):
        raise ValueError("ring matching takes pairs (i, j) with i < j")
    Vp = -(-V // n) * n
    if Vp != V:
        descs = torch.cat([descs, descs.new_zeros((Vp - V, Nmax, D))])
        counts = torch.cat([counts, counts.new_zeros(Vp - V)])
    Vl = Vp // n
    # the wanted pairs whose first view is local: pair index by (a, j)
    want = {}
    for k, (i, j) in enumerate(pair_ij.tolist()):
        if i // Vl == mesh.rank:
            want.setdefault((i - mesh.rank * Vl, j), []).append(k)
    got = []
    local_d = meshlib.shard_rows(descs, mesh)
    local_c = meshlib.shard_rows(counts.to(torch.int32), mesh)
    for owner, a, b, res in ring_sweep(local_d, local_c, mesh, ratio):
        a_l, j_l = a.tolist(), (owner * Vl + b).tolist()
        rows = [(r, want[(aa, jj)]) for r, (aa, jj) in enumerate(zip(a_l, j_l))
                if (aa, jj) in want]
        if not rows:
            continue
        sel = torch.as_tensor([r for r, _ in rows], device=res.mask.device)
        parts = [t[sel].cpu().numpy() for t in (res.idx_b, res.mask, res.dist)]
        for q, (_, ks) in enumerate(rows):
            for k in ks:
                got.append((k, parts[0][q], parts[1][q], parts[2][q]))
    everyone = [None] * n if mesh.rank == 0 else None
    dist.gather_object(got, everyone, dst=mesh.ranks[0], group=mesh.group)
    if mesh.rank != 0:
        return None
    P = len(pair_ij)
    idx_b = np.zeros((P, Nmax), np.int32)
    msk = np.zeros((P, Nmax), bool)
    dst = np.zeros((P, Nmax), np.float32)
    seen = np.zeros(P, bool)
    for part in everyone:
        for k, i_, m_, d_ in part:
            idx_b[k], msk[k], dst[k], seen[k] = i_, m_, d_, True
    if not seen.all():
        raise RuntimeError(f"{int((~seen).sum())} pairs were never matched on the ring")
    dev = mesh.device
    return matching.MatchResult(
        idx_a=torch.arange(Nmax, dtype=torch.int64, device=dev).expand(P, Nmax),
        idx_b=torch.as_tensor(idx_b, device=dev), mask=torch.as_tensor(msk, device=dev),
        dist=torch.as_tensor(dst, device=dev))
