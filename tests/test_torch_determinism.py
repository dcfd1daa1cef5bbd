"""Bitwise determinism of the port's stochastic paths (counterpart:
tests/test_determinism.py): matching, AC-RANSAC with fixed
torch.Generators and robust_relative_pose, each run twice on the CPU, give
the same bits; on the card (marked cuda) a small INCREMENTAL sfm run
twice writes the same scene files byte for byte."""

import math
import os

import numpy as np
import pytest
import torch

from openmvg_torch.ops import matching, ransac
from openmvg_torch.sfm import robust
from openmvg_torch.utils.synthetic import bearings_of, ring_scene


def _rerun(fn):
    a, b = fn(), fn()
    for x, y in zip(a, b):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_matching_deterministic():
    rng = np.random.default_rng(3)
    descs = torch.as_tensor(rng.integers(0, 256, (3, 512, 128), dtype=np.uint8))
    counts = torch.full((3,), 512, dtype=torch.int32)
    pairs = torch.tensor([[0, 1], [0, 2], [1, 2]], dtype=torch.int32)
    _rerun(lambda: matching.match_pair_batch(descs, counts, pairs))


def test_ac_ransac_deterministic():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 100, 150)
    y = 1.5 * x - 4.0 + rng.normal(scale=0.1, size=150)
    y[:40] = rng.uniform(0, 200, 40)
    pts = torch.as_tensor(np.stack([x, y], 1))[None]  # (1, N, 2)

    def fit(samples):  # (B, S, 2, 2) -> lines (B, S, 1, 2)
        (s,) = samples
        dx = s[..., 1, 0] - s[..., 0, 0]
        a = (s[..., 1, 1] - s[..., 0, 1]) / torch.where(dx.abs() < 1e-12, 1e-12, dx)
        m = torch.stack([a, s[..., 0, 1] - a * s[..., 0, 0]], -1)
        return m[:, :, None], torch.ones(m.shape[:2] + (1,), dtype=torch.bool)

    def err(m, data):  # (B, R, 2), ((B, N, 2),) -> (B, R, N)
        (p,) = data
        d = m[..., 0:1] * p[:, None, :, 0] - p[:, None, :, 1] + m[..., 1:2]
        return d * d / (m[..., 0:1] ** 2 + 1.0)

    def run():
        res = ransac.ac_ransac([torch.Generator().manual_seed(7)], fit, err, (pts,),
                               torch.ones(1, 150, dtype=torch.bool), min_samples=2,
                               logalpha0=ransac.logalpha0_point_to_line(200, 200),
                               mult_error=0.5, n_samples=128)
        return res.model, res.inliers, res.threshold_sq

    _rerun(run)
    model, inliers, _ = run()
    assert inliers.sum() >= 100 and abs(float(model[0, 0]) - 1.5) < 0.01


def test_robust_relative_pose_deterministic():
    s = ring_scene(n_views=2, n_points=120, seed=2)
    vis = np.nonzero(s.visible[0] & s.visible[1])[0]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64))

    b1, b2 = t(bearings_of(s, 0, vis)), t(bearings_of(s, 1, vis))
    K = t(s.K[0])

    def run():
        res = robust.robust_relative_pose(
            torch.Generator().manual_seed(0), b1, b2, t(s.x[0][vis]), t(s.x[1][vis]), K, K,
            torch.ones(len(vis), dtype=torch.bool), 1000, 1000, n_samples=256)
        return res.R, res.t, res.inliers

    _rerun(run)


@pytest.mark.cuda
def test_incremental_sfm_repeats_on_the_card(tmp_path):
    """Two INCREMENTAL runs on the card of one front end write the same
    sfm_data.json and cloud_and_poses.ply."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from openmvg_torch import cli
    from openmvg_torch.utils.synthetic import render_textured_sphere_dataset

    size, n = 256, 12
    imgdir, *_ = render_textured_sphere_dataset(str(tmp_path), n_views=n, size=size,
                                                focal=1.2 * size, seed=1,
                                                arc_step=min(2 * math.pi / n, 0.063),
                                                device="cuda")
    out, md = str(tmp_path / "out"), str(tmp_path / "matches")
    sfm = os.path.join(out, "sfm_data.json")
    for argv in (["init", "-i", imgdir, "-o", out, "-f", str(1.2 * size), "-c", "1"],
                 ["features", "-i", sfm, "-o", md, "-p", "HIGH"],
                 ["pairs", "-i", sfm, "-o", os.path.join(md, "pairs.txt")],
                 ["matches", "-i", sfm, "-o", os.path.join(md, "matches.putative.bin"),
                  "-p", os.path.join(md, "pairs.txt")],
                 ["filter", "-i", sfm, "-m", os.path.join(md, "matches.putative.bin"),
                  "-o", os.path.join(md, "matches.f.bin")]):
        assert cli.main(argv) == 0
    files = []
    for k in range(2):
        recon = str(tmp_path / f"recon{k}")
        assert cli.main(["sfm", "-i", sfm, "-m", md, "-M", os.path.join(md, "matches.f.bin"),
                         "-o", recon, "-s", "INCREMENTAL"]) == 0
        files.append([open(os.path.join(recon, f), "rb").read()
                      for f in ("sfm_data.json", "cloud_and_poses.ply")])
    assert files[0] == files[1]
