"""Host-side scaling of the port's incremental engine bookkeeping
(counterpart: tests/test_engine_scale.py): _TrackIndex and
_find_resection_group on a 500-view track table of 400,000 observations
stay in numpy time, each within 5 s, with the reference test's spot
checks."""

import time

import numpy as np

from openmvg_torch.sfm.pipeline_incremental import _find_resection_group, _TrackIndex
from openmvg_torch.sfm.tracks import Tracks


class _Cfg:
    resection_pct = 0.75


class _Scene:
    n_views = 500


def _big_tracks(n_views=500, n_tracks=50_000, obs_per_track=8, seed=0):
    rng = np.random.default_rng(seed)
    track_id = np.repeat(np.arange(n_tracks), obs_per_track)
    return Tracks(track_id=track_id.astype(np.int32),
                  view_id=rng.integers(0, n_views, len(track_id)).astype(np.int32),
                  feat_id=rng.integers(0, 2000, len(track_id)).astype(np.int32))


def test_track_index_scales():
    tracks = _big_tracks()
    feats = [np.random.default_rng(1).random((2000, 2)) * 1000 for _ in range(500)]
    t0 = time.perf_counter()
    index = _TrackIndex(tracks, feats)
    dt = time.perf_counter() - t0
    assert dt < 5.0, f"_TrackIndex build took {dt:.2f} s at 400k observations"
    rows = index.rows_of_view(123)
    assert np.array_equal(np.sort(rows), np.nonzero(tracks.view_id == 123)[0])
    r = rows[7]
    assert np.allclose(index.obs_xy[r], feats[tracks.view_id[r]][tracks.feat_id[r], :2])


def test_resection_group_scales():
    tracks = _big_tracks()
    index = _TrackIndex(tracks, [np.zeros((2000, 2)) for _ in range(500)])
    landmark_of_track = np.where(np.arange(tracks.n_tracks) % 3 == 0, 5, -1)
    t0 = time.perf_counter()
    for _ in range(20):  # 20 rounds
        group = _find_resection_group(_Scene, index, {0, 1, 2}, landmark_of_track, _Cfg, {})
    dt = time.perf_counter() - t0
    assert dt < 5.0, f"20 resection-group rounds took {dt:.2f} s"
    assert len(group) > 0 and 0 not in group and 1 not in group
