"""Feature tracks from pairwise matches (counterpart:
openmvg_tpu/sfm/tracks.py; openMVG tracks/tracks.hpp TracksBuilder).

Union-find fusion of the pairwise correspondences into multi-view tracks,
as the connected components of the (view, feature) match graph
(scipy.sparse.csgraph: the reference's path when its native library is
absent; both paths give the same tracks).  A track that touches one view twice
is dropped, as are tracks shorter than min_length.  Host side, numpy.
"""

from typing import Dict, NamedTuple, Tuple

import numpy as np
from scipy import sparse
from scipy.sparse import csgraph


class Tracks(NamedTuple):
    """Flat track table sorted by (track_id, view_id)."""

    track_id: np.ndarray  # (M,) int32, contiguous 0..T-1
    view_id: np.ndarray   # (M,) int32
    feat_id: np.ndarray   # (M,) int32

    @property
    def n_tracks(self):
        return 0 if len(self.track_id) == 0 else int(self.track_id[-1]) + 1

    def lengths(self):
        return np.bincount(self.track_id, minlength=self.n_tracks)


def _empty():
    return Tracks(*(np.zeros(0, np.int32),) * 3)


def build_tracks(pairwise_matches: Dict[Tuple[int, int], np.ndarray],
                 min_length: int = 2) -> Tracks:
    """{(i, j): (M_ij, 2) feature index pairs} -> Tracks (TracksBuilder::
    Build + Filter(min_length))."""
    edges = [(i, j, np.asarray(m, np.int64)) for (i, j), m in pairwise_matches.items()
             if len(m)]
    if not edges:
        return _empty()
    stride = np.int64(max(int(m.max()) for _, _, m in edges) + 1)
    a = np.concatenate([i * stride + m[:, 0] for i, _, m in edges])
    b = np.concatenate([j * stride + m[:, 1] for _, j, m in edges])
    nodes, inv = np.unique(np.concatenate([a, b]), return_inverse=True)
    ia, ib = inv[:len(a)], inv[len(a):]
    n = len(nodes)
    view = (nodes // stride).astype(np.int32)
    feat = (nodes % stride).astype(np.int32)
    g = sparse.coo_matrix((np.ones(len(ia), np.int8), (ia, ib)), shape=(n, n))
    _, labels = csgraph.connected_components(g, directed=False)

    order = np.lexsort((view, labels))
    lab_s, view_s, feat_s = labels[order], view[order], feat[order]
    same = np.zeros(len(lab_s), bool)
    same[1:] = (lab_s[1:] == lab_s[:-1]) & (view_s[1:] == view_s[:-1])
    keep = ~np.isin(lab_s, np.unique(lab_s[same]))       # conflicted tracks
    lengths = np.bincount(lab_s[keep])
    keep &= ~np.isin(lab_s, np.nonzero(lengths < min_length)[0])
    lab_k, view_k, feat_k = lab_s[keep], view_s[keep], feat_s[keep]
    _, new_ids = np.unique(lab_k, return_inverse=True)
    return Tracks(track_id=new_ids.astype(np.int32), view_id=view_k, feat_id=feat_k)


def tracks_in_views(tracks: Tracks, views) -> np.ndarray:
    """Sorted ids of the tracks visible in every one of `views`."""
    views = list(views)
    if tracks.n_tracks == 0:
        return np.zeros(0, np.int32)
    count = np.zeros(tracks.n_tracks, np.int32)
    for v in views:
        count[np.unique(tracks.track_id[tracks.view_id == v])] += 1
    return np.nonzero(count == len(views))[0].astype(np.int32)


def track_observations(tracks: Tracks, track_ids) -> Tracks:
    """The (track, view, feat) rows of `track_ids`."""
    sel = np.isin(tracks.track_id, track_ids)
    return Tracks(track_id=tracks.track_id[sel], view_id=tracks.view_id[sel],
                  feat_id=tracks.feat_id[sel])
