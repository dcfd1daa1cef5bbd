"""Port parity for INCREMENTALV2 (IncrementalConfig.engine_version 2), the
per-round dumps and depth cleaning, openmvg_torch against openmvg_tpu on
the CPU.

The engines draw from different random streams (torch.Generator against
jax.random), so the engine case compares outcomes: every pose, reprojection
rmse, trajectory error after 7-DoF alignment, and the two packages'
aligned camera centres within 1e-3 of each other.  depth_cleaning is host
numpy in both and is held to equality.
"""

import os

import numpy as np
import pytest
import torch

from openmvg_tpu.io.snapshot import load_snapshot as jload_snapshot
from openmvg_tpu.sfm import filters as jfilters
from openmvg_tpu.sfm.pipeline_incremental import IncrementalConfig as JConfig
from openmvg_tpu.sfm.pipeline_incremental import incremental_sfm as jincremental
from openmvg_tpu.sfm.scene import rmse as jrmse
from openmvg_tpu.utils.synthetic import ring_scene
from openmvg_torch.io import from_reference
from openmvg_torch.io.ply import load_ply_vertices
from openmvg_torch.sfm import filters as tfilters
from openmvg_torch.sfm.pipeline_incremental import IncrementalConfig, incremental_sfm
from openmvg_torch.sfm.scene import rmse
from tests.test_torch_incremental import CFG, _ate_aligned, _posed_ring, ring_data


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs on several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_incremental_v2_both_engines_on_ring_scene(tmp_path):
    """Both packages' INCREMENTALV2 on the 8-view ring: 8/8 poses, rmse <
    0.3 px, ATE < 0.02, aligned centres within 1e-3 of each other.  The
    port's per-round dumps are one PLY a round and a snapshot that the
    reference loads back to the final scene's poses."""
    s = ring_scene(n_views=8, n_points=120, seed=0)
    jsc, feats, matches = ring_data(s)
    tsc = from_reference(jsc)
    jincremental(jsc, feats, matches, JConfig(engine_version=2, **CFG), seed=0)
    dump = str(tmp_path / "dump")
    stats = {}
    incremental_sfm(tsc, feats, matches, IncrementalConfig(engine_version=2, dump_dir=dump,
                                                           **CFG),
                    seed=0, device="cpu", stats=stats)
    aligned = []
    for sc in (jsc, tsc):
        assert int(sc.pose_valid.sum()) == s.n_views
        al, ate = _ate_aligned(sc.pose_C, s.C)
        assert ate < 0.02
        aligned.append(al)
    assert rmse(tsc) < 0.3 and jrmse(jsc) < 0.3
    np.testing.assert_allclose(aligned[1], aligned[0], atol=1e-3)
    plys = sorted(f for f in os.listdir(dump) if f.endswith(".ply"))
    assert plys == [f"round_{r:03d}.ply" for r in range(1, stats["rounds"] + 1)]
    pts, _ = load_ply_vertices(os.path.join(dump, plys[-1]))
    assert len(pts) > 0
    snap = jload_snapshot(os.path.join(dump, "latest_snapshot.npz"))
    np.testing.assert_array_equal(snap.pose_valid, tsc.pose_valid)


@pytest.mark.parametrize("k_factor", [5.2, 1.5])
def test_depth_cleaning_matches_reference(k_factor):
    """Same observations kept, same poses and landmarks erased, same
    return value, on a posed ring with far points, points behind a camera
    and a view without a pose."""
    s, sc, ov, ol, x = _posed_ring(6)
    X = s.X.copy()
    X[::9] *= 40.0                       # far beyond the median depth
    X[5] = sc.pose_C[0] * 1.6            # behind camera 0
    sc.X = X
    sc.X_valid = np.ones(len(X), bool)
    sc.obs_view, sc.obs_landmark, sc.obs_x = ov, ol, x
    sc.obs_feat = ol.copy()
    sc.obs_valid = np.ones(len(ov), bool)
    sc.pose_valid[3] = False
    tsc = from_reference(sc)
    got = tfilters.depth_cleaning(tsc, k_factor, 12, 3)
    want = jfilters.depth_cleaning(sc, k_factor, 12, 3)
    assert got == want and np.isfinite(got)
    for f in ("obs_valid", "X_valid", "pose_valid"):
        np.testing.assert_array_equal(getattr(tsc, f), getattr(sc, f))
    assert 0 < tsc.obs_valid.sum() < len(ov)
