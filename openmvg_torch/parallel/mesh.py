"""Meshes of ranks, row shards and collectives (counterpart:
openmvg_tpu/parallel/mesh.py).

A Mesh is a process group, the global ranks in it and this rank's place
and device.  There is one process a rank (SPMD): a sharded array is, on
each rank, only that rank's contiguous rows, and a replicated one is the
whole array on every rank.  make_mesh(n) takes the first n ranks of the
world; ranks outside it get a Mesh with rank -1 and take no part.

The collectives take CUDA tensors under NCCL.  Under gloo, which carries
only CPU tensors, a CUDA tensor is staged through a host buffer here, in
the open: a copy to the host, the collective, a copy back.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from openmvg_torch.utils.collectives import all_reduce, is_gloo  # noqa: F401 (re-exported)


class Mesh(NamedTuple):
    group: object          # torch.distributed process group
    ranks: tuple           # global ranks of the mesh, in mesh order
    rank: int              # this rank's index in the mesh, -1 outside it
    device: torch.device   # this rank's device

    @property
    def size(self):
        return len(self.ranks)

    @property
    def member(self):
        return self.rank >= 0


def make_mesh(n_ranks=None, device=None):
    """Mesh of the first n_ranks ranks of the world (all of them by
    default).  Every rank of the world calls it with the same n_ranks
    (dist.new_group is collective)."""
    from openmvg_torch.parallel import runtime

    world = dist.get_world_size()
    n = world if n_ranks is None else int(n_ranks)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    ranks = tuple(range(n))
    group = dist.group.WORLD if n == world else dist.new_group(list(ranks))
    me = dist.get_rank()
    dev = torch.device(device) if device is not None else runtime.local_device()
    return Mesh(group=group, ranks=ranks, rank=ranks.index(me) if me in ranks else -1,
                device=dev)


def pad_to_multiple(a, m, fill=0):
    """numpy: rows of `fill` appended until the row count divides by m."""
    n = a.shape[0]
    k = (n + m - 1) // m * m
    if k == n:
        return a
    pad = np.full((k - n,) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def row_range(n_rows, rank, size):
    """Rows [lo, hi) of shard `rank` of `size` equal contiguous shards."""
    if n_rows % size:
        raise ValueError(f"{n_rows} rows do not split into {size} equal shards")
    per = n_rows // size
    return rank * per, (rank + 1) * per


def shard_rows(a, mesh):
    """This rank's contiguous rows of `a` (the counterpart of
    shard_leading), on the mesh's device."""
    lo, hi = row_range(a.shape[0], mesh.rank, mesh.size)
    return a[lo:hi].to(mesh.device)


def whole(a, mesh):
    """The whole of `a` on this rank's device (the counterpart of
    replicated)."""
    return a.to(mesh.device)


def all_gather_rows(t, mesh):
    """The mesh's shards of `t` concatenated in mesh order, on every rank."""
    stage = t.is_cuda and is_gloo(mesh.group)
    src = (t.cpu() if stage else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


def broadcast(t, mesh, src=0):
    """`t` of mesh rank `src` on every rank of the mesh."""
    stage = t.is_cuda and is_gloo(mesh.group)
    buf = (t.cpu() if stage else t).contiguous()
    dist.broadcast(buf, src=mesh.ranks[src], group=mesh.group)
    return buf.to(t.device)


def barrier(mesh):
    """Every rank of the mesh has reached this point."""
    if mesh.member:
        dist.barrier(group=mesh.group)
