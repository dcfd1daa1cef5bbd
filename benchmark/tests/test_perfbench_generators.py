"""The benchmark's input generators: the same seed gives the same inputs,
another seed other inputs, and the BAL generator hits the published counts."""

import numpy as np
import pytest

from benchmark.gen import bal, sphere

BIG = 2 ** 31 + 12345  # seeds may pass 32 signed bits


def test_sphere_views_repeat_for_a_seed_and_differ_across_seeds(tmp_path):
    kw = dict(scene_seed=2008, noise_gray=2.0)
    a = sphere.render_views(str(tmp_path / "a"), BIG, 2, 96, 64, 90.0, 0.063, **kw)
    b = sphere.render_views(str(tmp_path / "b"), BIG, 2, 96, 64, 90.0, 0.063, **kw)
    c = sphere.render_views(str(tmp_path / "c"), BIG + 1, 2, 96, 64, 90.0, 0.063, **kw)
    for name in a.names:
        pa, pb, pc = ((tmp_path / d / name).read_bytes() for d in "abc")
        assert pa == pb
        assert pa != pc
    np.testing.assert_array_equal(a.R, b.R)
    assert a.K[0, 2] == 48 and a.K[1, 2] == 32


def test_the_seed_draws_noise_on_the_sphere_only():
    tex = sphere.texture(2008)
    R, C = sphere.arc_poses(1, 0.063)
    import torch

    g = torch.Generator().manual_seed(5)
    clean = sphere.render_view(R[0], C[0], 90.0, 96, 64, tex)
    noisy = sphere.render_view(R[0], C[0], 90.0, 96, 64, tex, noise=(2.0, g))
    # the frame's corners look past the sphere (32.6 degrees off axis, the
    # sphere's edge at 27.8)
    for y, x in ((0, 0), (0, 95), (63, 0), (63, 95)):
        assert clean[y, x] == noisy[y, x] == 0
    assert (noisy != clean).mean() > 0.5
    assert np.abs(noisy.astype(int) - clean).max() <= 12


def test_png_writer_round_trips_through_zlib(tmp_path):
    import zlib

    img = (np.arange(12 * 7) % 251).astype(np.uint8).reshape(7, 12)
    sphere.write_png(str(tmp_path / "x.png"), img)
    data = (tmp_path / "x.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(7, 13)
    assert (raw[:, 0] == 0).all()
    np.testing.assert_array_equal(raw[:, 1:], img)


def test_bal_problem_repeats_for_a_seed_and_differs_across_seeds():
    a = bal.make_problem(BIG, 36, 2267, 12553)
    b = bal.make_problem(BIG, 36, 2267, 12553)
    c = bal.make_problem(BIG + 1, 36, 2267, 12553)
    for f in bal.BALProblem._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.x, c.x)


@pytest.mark.parametrize("scale", [100, 10])
def test_bal_problem_hits_the_published_counts_at_a_scale(scale):
    cams, pts, obs = 356, 226730, 1255268
    p = bal.make_problem(7, cams, pts // scale, obs // scale)
    assert len(p.R0) == cams
    assert len(p.X0) == pts // scale
    assert len(p.cam) == len(p.point) == len(p.x) == obs // scale
    k = np.bincount(p.point, minlength=pts // scale)
    assert k.min() >= 2 and k.max() <= cams
    # each point's cameras are distinct, and observations are in point order
    assert len(np.unique(p.point * cams + p.cam)) == len(p.cam)
    assert (np.diff(p.point) >= 0).all()


def test_bal_track_lengths_sum_to_the_published_count_exactly():
    k = bal.track_lengths(np.random.default_rng(3), 226730, 1255268, 356)
    assert int(k.sum()) == 1255268 and len(k) == 226730
    assert k.min() >= 2 and k.max() <= 356


def test_bal_observations_are_the_truth_projected_with_noise():
    p = bal.make_problem(11, 20, 500, 3000, noise_px=0.0, outlier_share=0.0)
    np.testing.assert_allclose(bal.project(p.R, p.t, p.intr, p.X, p.cam, p.point), p.x,
                               atol=1e-9)
