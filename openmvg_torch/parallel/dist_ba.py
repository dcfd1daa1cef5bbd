"""Sharded bundle adjustment over a mesh of ranks (counterpart:
openmvg_tpu/parallel/dist_ba.py).

Two modes, both one process a rank running the same LM loop
(sfm/ba.py's adjust with the mesh's process group):

  observation-sharded  (adjust_distributed) the observation table, padded
      to a multiple of the mesh size with obs_w = 0 rows, is cut into
      contiguous shards; poses, intrinsics and points are whole on every
      rank, and every camera and point sum is all-reduced.
  point-sharded  (adjust_point_sharded) rank k owns the contiguous point
      block [k n_local, (k + 1) n_local) and all the observations of those
      points (partition_by_point); only the camera sums, the cost and the
      point term of the predicted gain are all-reduced, and X and its
      point blocks never exist whole on a rank.

Every rank is handed the same host problem and puts only its shard on its
device.  The shards have no point tables (pt_obs None): the reference's
tables index the whole observation table, and a rank's point sums go
through K2 with a plan of its own (ba.with_plans), as do its camera sums.
"""

import numpy as np
import torch

from openmvg_torch.parallel import mesh as meshlib
from openmvg_torch.sfm import ba

_OBS = ("obs_pose", "obs_intr", "obs_point", "obs_x", "obs_w")


def _pad_rows(a, n):
    """Rows of zeros appended up to n rows (a truncation when longer)."""
    if a.shape[0] >= n:
        return a[:n]
    return torch.cat([a, a.new_zeros((n - a.shape[0],) + a.shape[1:])])


def pad_problem(p: ba.BAProblem, n_shards: int) -> ba.BAProblem:
    """The observation table padded to a multiple of n_shards with
    obs_w = 0 rows (ids 0), without point tables."""
    O = p.obs_pose.shape[0]
    k = (O + n_shards - 1) // n_shards * n_shards
    fix = dict(pt_obs=None, seg_plans=None, point_plan=None)
    if k == O:
        return p._replace(**fix)
    return p._replace(**{f: _pad_rows(getattr(p, f), k) for f in _OBS}, **fix)


def local_shard(p: ba.BAProblem, mesh, shard_points):
    """This rank's shard of a padded or partitioned problem, on its
    device: its rows of the observations (and of the points when
    shard_points), the rest whole."""
    rows = _OBS + (("X", "mask_X") if shard_points else ())
    parts = {f: (meshlib.shard_rows if f in rows else meshlib.whole)(getattr(p, f), mesh)
             for f in ba.BAProblem._fields[:16]}
    return ba.BAProblem(**parts)


def make_distributed_lm_step(mesh, cfg: ba.BAConfig):
    """lm_step on this rank's observation shard, parameters whole."""
    def step(p_local, lam):
        return ba.lm_step(ba.with_plans(p_local), lam, cfg, group=mesh.group)
    return step


def _params_back(p, p_local, X=None):
    """The input problem with the solved parameters (on the input's
    device)."""
    dev = p.X.device
    return p._replace(rotvec=p_local.rotvec.to(dev), t=p_local.t.to(dev),
                      intr_params=p_local.intr_params.to(dev),
                      X=(p_local.X if X is None else X).to(dev))


def adjust_distributed(p: ba.BAProblem, mesh, cfg: ba.BAConfig = ba.BAConfig()):
    """Observation-sharded counterpart of ba.adjust, run on every rank of
    the mesh with the same host problem.  Returns (problem with the solved
    parameters, final cost)."""
    local = local_shard(pad_problem(p, mesh.size), mesh, shard_points=False)
    out, cost, _ = ba.adjust(local, cfg, group=mesh.group)
    return _params_back(p, out), float(cost)


# ---------------------------------------------------------------------------
# point-block-sharded mode
# ---------------------------------------------------------------------------

def partition_by_point(p: ba.BAProblem, n_shards: int):
    """Re-layout so shard k owns the contiguous point block [k n_local,
    (k + 1) n_local) and all the observations of those points.  Returns
    (problem, meta): obs_point ids become shard-local, each shard's
    observations are padded to the largest shard's count with obs_w = 0
    rows, X and mask_X padded to n_local n_shards rows; poses and
    intrinsics stay whole."""
    L = int(p.X.shape[0])
    n_local = max((L + n_shards - 1) // n_shards, 1)
    obs_point = p.obs_point.cpu().numpy()
    shard = obs_point // n_local
    order = np.argsort(shard, kind="stable")
    counts = np.bincount(shard, minlength=n_shards)
    O_local = int(counts.max()) if len(counts) else 1
    # destination row of each observation, in shard order
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    dest = np.empty(len(order), np.int64)
    dest[order] = (np.repeat(np.arange(n_shards) * O_local, counts)
                   + np.arange(len(order)) - np.repeat(starts, counts))
    dest_t = torch.as_tensor(dest, device=p.obs_point.device)

    def regroup(a):
        out = a.new_zeros((n_shards * O_local,) + a.shape[1:])
        out[dest_t] = a
        return out

    local_point = torch.as_tensor(obs_point - shard * n_local, dtype=p.obs_point.dtype,
                                  device=p.obs_point.device)
    p_new = p._replace(
        X=_pad_rows(p.X, n_local * n_shards), mask_X=_pad_rows(p.mask_X, n_local * n_shards),
        pt_obs=None, seg_plans=None, point_plan=None,
        obs_pose=regroup(p.obs_pose), obs_intr=regroup(p.obs_intr),
        obs_point=regroup(local_point), obs_x=regroup(p.obs_x), obs_w=regroup(p.obs_w))
    return p_new, dict(n_local=n_local, n_shards=n_shards, L=L, O_local=O_local)


def unpartition_X(X_sharded, meta):
    """The dense (L, 3) points: the padded layout truncated."""
    return X_sharded[: meta["L"]]


def make_point_sharded_lm_step(mesh, cfg: ba.BAConfig):
    """lm_step on this rank's point block and its observations."""
    def step(p_local, lam):
        return ba.lm_step(ba.with_plans(p_local), lam, cfg, group=mesh.group,
                          shard_points=True)
    return step


def local_point_shard(p: ba.BAProblem, mesh):
    """partition_by_point for the mesh, and this rank's shard of it on its
    device.  Returns (local problem, meta)."""
    ps, meta = partition_by_point(p, mesh.size)
    return local_shard(ps, mesh, shard_points=True), meta


def adjust_point_sharded(p: ba.BAProblem, mesh, cfg: ba.BAConfig = ba.BAConfig()):
    """Point-sharded counterpart of ba.adjust, run on every rank of the
    mesh with the same host problem.  Returns (problem with the solved
    parameters in the original point order, final cost); the points are
    gathered from their owners once, at the end."""
    local, meta = local_point_shard(p, mesh)
    out, cost, _ = ba.adjust(local, cfg, group=mesh.group, shard_points=True)
    X = unpartition_X(meshlib.all_gather_rows(out.X, mesh), meta)
    return _params_back(p, out, X), float(cost)
