"""The plain reference on hand-worked cases."""

import math

import numpy as np
import pytest
import torch

from benchmark.gen import bal
from benchmark.reference import bal_lm, sfm_check


def _two_views():
    K = np.array([[100.0, 0, 50], [0, 100.0, 40], [0, 0, 1]])
    Ri, Ci = np.eye(3), np.zeros(3)
    Rj, Cj = np.eye(3), np.array([1.0, 0, 0])  # pure sideways step: horizontal lines
    return K, Ri, Ci, Rj, Cj


def test_epipolar_lines_of_a_sideways_step_are_rows():
    K, Ri, Ci, Rj, Cj = _two_views()
    F = sfm_check.fundamental(K, Ri, Ci, Rj, Cj)
    xi = np.array([[10.0, 30.0], [70.0, 55.0]])
    xj = np.array([[-20.0, 33.0], [5.0, 55.0]])  # 3 px and 0 px off the row
    np.testing.assert_allclose(sfm_check.epipolar_px(F, xi, xj), [3.0, 0.0], atol=1e-12)


def test_epi_bad_share_counts_matches_beyond_4px():
    K, Ri, Ci, Rj, Cj = _two_views()
    feats = [np.array([[10.0, 30.0], [20.0, 30.0]]), np.array([[0.0, 30.0], [0.0, 35.0]])]
    matches = {(0, 1): np.array([[0, 0], [1, 1]])}
    share = sfm_check.epi_bad_share(matches, feats, K, np.stack([Ri, Rj]), np.stack([Ci, Cj]))
    assert share == 0.5


def test_epi_bad_share_counts_a_distance_that_is_not_a_number_as_far():
    K, Ri, Ci, Rj, Cj = _two_views()
    feats = [np.array([[10.0, 30.0], [np.nan, 30.0]]), np.array([[0.0, 30.0], [0.0, 30.0]])]
    matches = {(0, 1): np.array([[0, 0], [1, 1]])}
    share = sfm_check.epi_bad_share(matches, feats, K, np.stack([Ri, Rj]), np.stack([Ci, Cj]))
    assert share == 0.5


def test_similarity_recovers_a_planted_one():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(10, 3))
    R = bal._rodrigues(np.array([[0.3, -0.2, 0.1]]))[0]
    dst = 2.5 * src @ R.T + [1.0, -2.0, 0.5]
    s, Rh, t = sfm_check.similarity(src, dst)
    assert s == pytest.approx(2.5)
    np.testing.assert_allclose(Rh, R, atol=1e-12)
    np.testing.assert_allclose(t, [1.0, -2.0, 0.5], atol=1e-12)


def _scene(offset=0.0):
    R = np.eye(3)
    views = {0: ("a.png", 0, 0), 1: ("b.png", 0, 1)}
    poses = {0: (R, np.zeros(3)), 1: (R, np.array([1.0, 0, 0]))}
    X = np.array([[0.0, 0.0, 5.0], [1.0, 1.0, 4.0]])
    intr = {0: (100.0, 50.0, 40.0, 0.0, 0.0, 0.0)}
    ov, ol, ox = [], [], []
    for v, (_, C) in poses.items():
        for i, x in enumerate(X):
            p = (x - C)[:2] / (x - C)[2]
            ov.append(v)
            ol.append(i)
            ox.append(100 * p + [50, 40] + [offset, 0])
    return dict(views=views, intrinsics=intr, poses=poses, X=X,
                obs=(np.array(ov), np.array(ol), np.array(ox)))


def test_reprojection_rmse_of_an_exact_and_an_offset_scene():
    assert sfm_check.reproj_rmse_px(_scene()) == pytest.approx(0.0, abs=1e-12)
    assert sfm_check.reproj_rmse_px(_scene(3.0)) == pytest.approx(3.0)


def test_radial_distortion_in_the_reprojection():
    s = _scene()
    s["intrinsics"] = {0: (100.0, 50.0, 40.0, 0.1, 0.0, 0.0)}
    ov, ol, ox = s["obs"]
    # the first point lies on the axis of view 0: no distortion there
    Xc = s["X"][1] - np.zeros(3)
    p = Xc[:2] / Xc[2]
    want = 100 * p * (1 + 0.1 * (p @ p)) + [50, 40]
    got = np.sqrt(((want - ox[1]) ** 2).sum() / len(ov))
    err = sfm_check.reproj_rmse_px(s)
    assert err >= got - 1e-12


def test_pose_errors_count_the_unposed_views():
    names = ["a.png", "b.png", "c.png", "d.png"]
    C = np.array([[0.0, 0, 0], [1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    scene = dict(views={i: (n, 0, i) for i, n in enumerate(names)},
                 poses={i: (np.eye(3), 2 * C[i] + 1) for i in range(3)})
    unposed, rmse = sfm_check.pose_errors(scene, names, C)
    assert unposed == 1 and rmse == pytest.approx(0.0, abs=1e-12)


def test_round_mantissa_to_tf32():
    assert sfm_check.round_mantissa(1.0 + 2 ** -11, 10) == 1.0      # a tie, to even
    assert sfm_check.round_mantissa(1.0 + 3 * 2 ** -11, 10) == 1.0 + 2 ** -9
    assert sfm_check.round_mantissa(-3.0, 10) == -3.0


@pytest.mark.parametrize("s,want", [(9.0, 9.0), (16.0, 16.0), (64.0, 2 * math.sqrt(16 * 64) - 16)])
def test_huber_cost_of_one_residual(s, want):
    R = torch.eye(3, dtype=torch.float64)[None]
    t = torch.zeros((1, 3), dtype=torch.float64)
    intr = torch.tensor([[100.0, 0.0, 0.0]], dtype=torch.float64)
    X = torch.tensor([[0.0, 0.0, 2.0]], dtype=torch.float64)
    x = torch.tensor([[math.sqrt(s), 0.0]], dtype=torch.float64)  # projects to 0
    z = torch.zeros(1, dtype=torch.long)
    assert bal_lm.robust_cost(R, t, intr, X, z, z, -x) == pytest.approx(0.5 * want)


def _torch_problem(p):
    T = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    return ((T(p.R0), T(p.t0), T(p.intr0), T(p.X0)),
            (torch.as_tensor(p.cam), torch.as_tensor(p.point), T(p.x)))


def test_jacobians_match_forward_mode():
    from torch.func import jacfwd

    p = bal.make_problem(5, 12, 200, 1000)
    (R, t, intr, X), data = _torch_problem(p)
    intr = intr + torch.tensor([0.0, 0.03, -0.01], dtype=torch.float64)
    _, Jc, Jx = bal_lm._jacobians(R, t, intr, X, *data)

    def f(dc, dX):
        R1 = (torch.eye(3, dtype=torch.float64) + bal_lm._hat(dc[:, :3])) @ R
        return bal_lm.residuals(R1, t + dc[:, 3:6], intr + dc[:, 6:9], X + dX, *data)[0]

    Jn = jacfwd(f, argnums=(0, 1))(torch.zeros(12, 9, dtype=torch.float64),
                                   torch.zeros(200, 3, dtype=torch.float64))
    o = torch.arange(40)
    cam, pt = data[0][o], data[1][o]
    torch.testing.assert_close(Jn[0][o, :, cam, :], Jc[o], rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(Jn[1][o, :, pt, :], Jx[o], rtol=1e-9, atol=1e-9)


def test_solve_reaches_the_truth_without_noise():
    p = bal.make_problem(9, 12, 300, 1500, noise_px=0.0, outlier_share=0.0)
    start, data = _torch_problem(p)
    *_, cost, steps = bal_lm.solve(*start, *data, rows_per_chunk=100)
    assert cost < 1e-12 * bal_lm.robust_cost(*start, *data)
