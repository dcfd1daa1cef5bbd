"""The port's parallel layer without processes, against openmvg_tpu's:
the partitioner's three functions, pad_problem's and partition_by_point's
layouts (and the unpartition round trip), the mesh helpers, and the
synthetic fixtures the sharded paths use (big_ba_problem, bearings_of,
render_blob_dataset), on the same inputs on the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmvg_tpu.parallel import dist_ba as jdist
from openmvg_tpu.parallel import mesh as jmesh
from openmvg_tpu.parallel import partitioner as jpart
from openmvg_tpu.sfm import ba as jba
from openmvg_tpu.utils import synthetic as jsyn
from openmvg_torch.io.image import read_image
from openmvg_torch.parallel import dist_ba, partitioner
from openmvg_torch.parallel import mesh as meshlib
from openmvg_torch.sfm import ba
from openmvg_torch.utils import synthetic
from tests.test_ba import scene_from_ring
from tests.test_torch_ba import fields_of

OBS = ("obs_pose", "obs_intr", "obs_point", "obs_x", "obs_w")


def np_(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _problems(n_views, n_points, seed):
    sc = scene_from_ring(jsyn.ring_scene(n_views=n_views, n_points=n_points, seed=seed),
                         noise_X=0.02, seed=seed + 1)
    jp, _ = jba.problem_from_scene(sc, dtype=jnp.float64)
    return jp, ba.problem_from_reference(fields_of(jp))


@pytest.mark.parametrize("weighted", [False, True])
def test_partition_pairs_equals_reference(weighted):
    pairs = [(i, j) for i in range(10) for j in range(i + 1, 10)]
    counts = {v: 1000 + 100 * v for v in range(10)} if weighted else None
    got = partitioner.partition_pairs(pairs, 4, counts)
    assert got == jpart.partition_pairs(pairs, 4, counts)
    assert sorted(p for s in got for p in s) == pairs


def test_partition_observations_and_residency_equal_reference():
    rng = np.random.default_rng(0)
    obs_pose = rng.integers(0, 20, 1000)
    obs_point = rng.integers(0, 300, 1000)
    order, bounds = partitioner.partition_observations(obs_pose, 4)
    jorder, jbounds = jpart.partition_observations(obs_pose, 4)
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_array_equal(bounds, jbounds)
    rep = partitioner.residency_report(obs_pose, obs_point, order, bounds)
    assert rep == jpart.residency_report(obs_pose, obs_point, jorder, jbounds)
    assert rep["poses_single_shard"] > 0.7


@pytest.mark.parametrize("n_shards", [3, 8])
def test_pad_problem_equals_reference(n_shards):
    jp, tp = _problems(6, 40, 0)
    jq, tq = jdist.pad_problem(jp, n_shards), dist_ba.pad_problem(tp, n_shards)
    assert tq.pt_obs is None and jq.pt_obs is None
    assert tq.obs_pose.shape[0] % n_shards == 0
    for f in OBS + ("X", "rotvec"):
        np.testing.assert_array_equal(np_(getattr(tq, f)), np_(getattr(jq, f)), err_msg=f)


@pytest.mark.parametrize("n_shards", [3, 8])
def test_partition_by_point_equals_reference(n_shards):
    jp, tp = _problems(6, 40, 0)
    jq, jmeta = jdist.partition_by_point(jp, n_shards)
    tq, meta = dist_ba.partition_by_point(tp, n_shards)
    assert meta == jmeta
    for f in OBS + ("X", "mask_X"):
        np.testing.assert_array_equal(np_(getattr(tq, f)), np_(getattr(jq, f)), err_msg=f)


def test_point_partition_roundtrip():
    """Every observation is present once with its pixel, the local ids stay
    in the shard's block, and unpartition_X gives the points back."""
    _, tp = _problems(6, 40, 0)
    ps, meta = dist_ba.partition_by_point(tp, 8)
    orig = np_(tp.obs_x)[np_(tp.obs_w) > 0]
    new = np_(ps.obs_x)[np_(ps.obs_w) > 0]
    assert len(orig) == len(new)
    np.testing.assert_array_equal(np.sort(orig.ravel()), np.sort(new.ravel()))
    assert np_(ps.obs_point).max() < meta["n_local"]
    np.testing.assert_array_equal(np_(dist_ba.unpartition_X(ps.X, meta)), np_(tp.X))


def test_mesh_helpers():
    a = np.arange(14, dtype=np.int32).reshape(7, 2)
    for m in (1, 3, 4, 7):
        np.testing.assert_array_equal(meshlib.pad_to_multiple(a, m, fill=-1),
                                      jmesh.pad_to_multiple(a, m, fill=-1))
    assert [meshlib.row_range(12, r, 4) for r in range(4)] == [(0, 3), (3, 6), (6, 9), (9, 12)]
    with pytest.raises(ValueError):
        meshlib.row_range(10, 0, 4)


def test_big_ba_problem_equals_reference():
    """The same seed gives the reference's problem: equal once the padding
    rows (obs_w = 0) of both layouts are dropped, rotvec within 1e-12."""
    jp, jO = jsyn.big_ba_problem(n_poses=16, n_points=500, obs_per_point=6, seed=0,
                                 dtype=jnp.float64)
    tp, tO = synthetic.big_ba_problem(n_poses=16, n_points=500, obs_per_point=6, seed=0,
                                      dtype=torch.float64)
    assert tO == jO == 3000
    jk, tk = np_(jp.obs_w) > 0, np_(tp.obs_w) > 0
    assert jk.sum() == tk.sum() == 3000
    for f in OBS:
        np.testing.assert_array_equal(np_(getattr(tp, f))[tk], np_(getattr(jp, f))[jk],
                                      err_msg=f)
    np.testing.assert_allclose(np_(tp.rotvec), np_(jp.rotvec), rtol=0, atol=1e-12)
    for f in ("t", "X", "intr_params", "intr_wh", "intr_kind", "mask_pose", "mask_intr",
              "mask_X"):
        np.testing.assert_array_equal(np_(getattr(tp, f)), np_(getattr(jp, f)), err_msg=f)
    # the port's point tables sum the same points as the reference's
    v = np.random.default_rng(1).normal(size=(tp.obs_pose.shape[0], 3)) * tk[:, None]
    got = ba._pt_seg_sum(torch.as_tensor(v), tp, 500)
    want = np.zeros((500, 3))
    np.add.at(want, np_(tp.obs_point)[tk], v[tk])
    np.testing.assert_allclose(np_(got), want, rtol=1e-12, atol=1e-12)


def test_bearings_of_equals_reference():
    s = synthetic.ring_scene(n_views=5, n_points=30, seed=3)
    js = jsyn.ring_scene(n_views=5, n_points=30, seed=3)
    for v, idx in ((0, None), (3, np.array([1, 4, 7]))):
        np.testing.assert_array_equal(synthetic.bearings_of(s, v, idx),
                                      jsyn.bearings_of(js, v, idx))


def test_render_blob_dataset_equals_reference(tmp_path):
    kw = dict(n_views=3, n_points=120, size=96, focal=120.0, seed=4)
    got = synthetic.render_blob_dataset(str(tmp_path / "port"), **kw)
    want = jsyn.render_blob_dataset(str(tmp_path / "ref"), **kw)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a, b)
    for v in range(3):
        name = f"img_{v:02d}.png"
        np.testing.assert_array_equal(read_image(os.path.join(got[0], name)),
                                      read_image(os.path.join(want[0], name)))
        with open(os.path.join(got[1], name + ".camera")) as f1, \
                open(os.path.join(want[1], name + ".camera")) as f2:
            assert f1.read() == f2.read()
