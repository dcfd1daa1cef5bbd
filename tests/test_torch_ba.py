"""Port parity for the bundle adjuster: openmvg_torch/sfm/ba.py against
openmvg_tpu/sfm/ba.py on the same problems, both in float64 on the CPU,
and the cases of tests/test_ba.py run through the port.

One problem feeds both sides: the reference builds it from a scene, and
problem_from_reference hands its fields to the port.  Residuals,
Jacobians and one LM step agree to 1e-9 relative: the arithmetic is the
same, but sums run in another order (index_add_ and reshape-sums against
XLA's one-hot products and segment sums).  After several LM steps the
costs agree to 1e-6 relative: CG stops on a tolerance, so rounding can
shift an iteration count, and LM absorbs that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmvg_tpu.models import cameras as jcm
from openmvg_tpu.sfm import ba as jba
from openmvg_tpu.sfm.scene import Scene as JScene
from openmvg_tpu.utils.synthetic import ring_scene
from openmvg_torch.io import from_reference
from openmvg_torch.sfm import ba as tba
from openmvg_torch.sfm.scene import reprojection_residuals, rmse


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs on several workers at once, and
    small tensors gain nothing from more threads than the cores allow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ring_ref_scene(s, noise_X=0.0, noise_pose=0.0, noise_px=0.0, seed=0,
                   kind=jcm.PINHOLE, disto=()):
    """The reference's Scene of a ring_scene, every visible point observed."""
    rng = np.random.default_rng(seed)
    sc = JScene()
    V, P = s.n_views, s.n_points
    sc.view_filename = [f"v{i}.jpg" for i in range(V)]
    sc.view_intrinsic = np.zeros(V, np.int32)
    sc.view_pose = np.arange(V, dtype=np.int32)
    sc.view_wh = np.tile([[1000, 1000]], (V, 1)).astype(np.int32)
    sc.cameras = jcm.make_pinhole(1000, 1000, s.K[0, 0, 0], s.K[0, 0, 2], s.K[0, 1, 2],
                                  kind=kind, disto=disto)
    sc.pose_valid = np.ones(V, bool)
    sc.pose_R = s.R.copy()
    sc.pose_C = s.C + (rng.normal(scale=noise_pose, size=s.C.shape) if noise_pose else 0.0)
    sc.X = s.X + (rng.normal(scale=noise_X, size=s.X.shape) if noise_X else 0.0)
    sc.X_valid = np.ones(P, bool)
    ov, ol = np.nonzero(s.visible)
    sc.obs_landmark = ol.astype(np.int32)
    sc.obs_view = ov.astype(np.int32)
    sc.obs_x = s.x[ov, ol] + (rng.normal(scale=noise_px, size=(len(ol), 2))
                              if noise_px else 0.0)
    sc.obs_feat = ol.astype(np.int32)
    sc.obs_valid = np.ones(len(ol), bool)
    return sc


def fields_of(jp):
    f = {k: np.asarray(getattr(jp, k)) for k in jp._fields if k != "pt_obs"}
    t = jp.pt_obs
    f["pt_obs"] = None if t is None else tuple(
        None if a is None else np.asarray(a) for a in t)
    return f


def close(got, ref, rtol=1e-9, atol=1e-9):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def _problem(kind, disto, seed, refine=jba.ADJUST_ALL):
    s = ring_scene(n_views=6, n_points=60, seed=seed)
    sc = ring_ref_scene(s, noise_X=0.01, noise_pose=0.01, noise_px=0.3, seed=seed + 1,
                        kind=kind, disto=disto)
    jp, _ = jba.problem_from_scene(sc, refine_intrinsics=refine, dtype=jnp.float64)
    return jp, tba.problem_from_reference(fields_of(jp))


KINDS = [(jcm.PINHOLE, ()), (jcm.PINHOLE_RADIAL_K3, (-0.05, 0.01, 0.001)),
         (jcm.PINHOLE_BROWN, (-0.05, 0.01, 0.001, 1e-3, -1e-3))]


@pytest.mark.parametrize("kind,disto", KINDS)
def test_residuals_jacobians_match(kind, disto):
    jp, tp = _problem(kind, disto, 0)
    cfg = jba.BAConfig()
    tcfg = tba.BAConfig()
    fast = kind == jcm.PINHOLE
    close(tba.residuals(tp, fast), jba.residuals(jp, fast))
    for a, b in zip(tba.jacobians(tp, tcfg, fast), jba.jacobians(jp, cfg, fast)):
        close(a, b)
    if fast:  # the closed form agrees with forward mode
        for a, b in zip(tba.jacobians(tp, tcfg, True), tba.jacobians(tp, tcfg, False)):
            close(a, b, rtol=1e-8, atol=1e-8)
    close(tba.robust_cost(tp, tcfg, fast), jba.robust_cost(jp, cfg, cam_fast=fast))


@pytest.mark.parametrize("kind,disto", KINDS[:2])
def test_one_lm_step_matches(kind, disto):
    jp, tp = _problem(kind, disto, 2)
    cfg = jba.BAConfig()
    jp2, jlam, jcost, jacc = jba.lm_step(jp, 1e-4, cfg)
    tp2, tlam, tcost, tacc = tba.lm_step(tp, 1e-4, tba.BAConfig())
    assert bool(tacc) == bool(jacc)
    close(tcost, jcost)
    close(tlam, jlam)
    for f in ("rotvec", "t", "intr_params", "X"):
        close(getattr(tp2, f), getattr(jp2, f), rtol=1e-9, atol=1e-9)


def test_segment_sums_match_reference():
    """_seg_sum (K2's plain version on the CPU) and the point-major sums
    against the reference's one-hot / reshape paths."""
    jp, tp = _problem(jcm.PINHOLE, (), 4)
    rng = np.random.default_rng(5)
    O = tp.obs_pose.shape[0]
    v = rng.normal(size=(O, 6, 6))
    close(tba._seg_sum(torch.as_tensor(v), tp.obs_pose, tp.rotvec.shape[0]),
          jba._seg_sum(jnp.asarray(v), jp.obs_pose, jp.rotvec.shape[0]))
    v3 = rng.normal(size=(O, 3))
    close(tba._pt_seg_sum(torch.as_tensor(v3), tp, tp.X.shape[0]),
          jba._pt_seg_sum(jnp.asarray(v3), jp, jp.X.shape[0]))
    close(tba._pt_expand(tp.X, tp), jba._pt_expand(jp.X, jp))


def test_adjust_fixed_steps_cost_matches():
    """Six LM steps on both sides (no early stop): costs within 1e-6."""
    jp, tp = _problem(jcm.PINHOLE, (), 6)
    jcfg = jba.BAConfig(max_iterations=6, function_tolerance=0.0)
    jp2, jcost, jn = jba.adjust(jp, jcfg)
    tp2, tcost, tn = tba.adjust(tp, tba.BAConfig(max_iterations=6, function_tolerance=0.0))
    assert tn == jn
    assert abs(tcost - jcost) <= 1e-6 * abs(jcost)
    close(tp2.X, jp2.X, rtol=1e-5, atol=1e-7)


def test_problem_from_scene_matches_reference():
    """The same scene through both packages, the reference's without pose
    and point padding (pad_pow2=False): identical values.  The port lays
    out only the point-major rows the points need; the reference pads the
    row count to a power of two with obs_w = 0 rows, so the observation
    fields agree on the port's rows and the reference's rest carry no
    weight."""
    s = ring_scene(n_views=7, n_points=70, seed=8)
    sc = ring_ref_scene(s, noise_X=0.01, seed=9)
    jp, jm = jba.problem_from_scene(sc, refine_intrinsics=jba.ADJUST_ALL,
                                    dtype=jnp.float64, pad_pow2=False)
    tp, tm = tba.problem_from_scene(from_reference(sc), refine_intrinsics=tba.ADJUST_ALL,
                                    dtype=torch.float64)
    n_obs, n_rows = tp.obs_pose.shape[0], tp.pt_obs.row_point.shape[0]
    obs_fields = ("obs_pose", "obs_intr", "obs_point", "obs_x", "obs_w")
    for f in jp._fields[:16]:
        ref = np.asarray(getattr(jp, f))
        close(getattr(tp, f), ref[:n_obs] if f in obs_fields else ref, rtol=0, atol=1e-12)
    assert not np.asarray(jp.obs_w)[n_obs:].any()
    assert n_obs == n_rows * (np.asarray(jp.obs_w).shape[0] // jp.pt_obs.row_point.shape[0])
    close(tp.pt_obs.row_point, np.asarray(jp.pt_obs.row_point)[:n_rows], rtol=0, atol=0)
    close(tp.pt_obs.groups, jp.pt_obs.groups, rtol=0, atol=0)
    for k in ("pose_ids", "intr_ids", "point_ids"):
        np.testing.assert_array_equal(tm[k], jm[k])


def test_point_sums_without_group_table_match():
    """A problem whose group table was over its budget folds point rows
    through K2 (its plain version here): the same sums as the group
    table's, and as the reference's own path without one."""
    jp, tp = _problem(jcm.PINHOLE, (), 4)
    v3 = np.random.default_rng(6).normal(size=(tp.obs_pose.shape[0], 3, 3))
    tp_ng = tp._replace(pt_obs=tp.pt_obs._replace(groups=None))
    jp_ng = jp._replace(pt_obs=jp.pt_obs._replace(groups=None))
    L = tp.X.shape[0]
    got = tba._pt_seg_sum(torch.as_tensor(v3), tp_ng, L)
    close(got, tba._pt_seg_sum(torch.as_tensor(v3), tp, L), rtol=1e-12, atol=1e-12)
    close(got, jba._pt_seg_sum(jnp.asarray(v3), jp_ng, L))


@pytest.mark.parametrize("num", [1025, 5000])
def test_seg_sum_beyond_1024_segments_matches_reference(num):
    """Sums over more segments than the TPU kernel's 1024 (point-side sums
    of a problem without a point table) take K2's path as well: the plain
    version here, against the reference's _seg_sum (segment_sum above its
    one-hot limit)."""
    rng = np.random.default_rng(num)
    v = rng.normal(size=(3 * num, 2, 3))
    ids = rng.integers(0, num, size=3 * num)
    close(tba._seg_sum(torch.as_tensor(v), torch.as_tensor(ids), num),
          jba._seg_sum(jnp.asarray(v), jnp.asarray(ids, jnp.int32), num))


# ---------------------------------------------------------------------------
# the cases of tests/test_ba.py, through the port (float64 unless stated)
# ---------------------------------------------------------------------------

def _port_scene(s, **kw):
    return from_reference(ring_ref_scene(s, **kw))


def _run(sc, dtype=torch.float64, iters=20, **kw):
    cfg_kw = {k: kw.pop(k) for k in ("use_huber",) if k in kw}
    prob, maps = tba.problem_from_scene(sc, dtype=dtype, **kw)
    prob, cost, n_acc = tba.adjust(prob, tba.BAConfig(max_iterations=iters, **cfg_kw))
    tba.scene_from_problem(sc, prob, maps)
    return n_acc


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ba_recovers_noisy_structure(dtype):
    sc = _port_scene(ring_scene(n_views=8, n_points=80, seed=0), noise_X=0.02, seed=1)
    assert rmse(sc) > 1.0
    assert _run(sc, dtype) > 0
    assert rmse(sc) < (0.01 if dtype == torch.float64 else 0.05)


def test_ba_poses_and_structure():
    sc = _port_scene(ring_scene(n_views=8, n_points=80, seed=2), noise_X=0.01,
                     noise_pose=0.02, seed=3)
    _run(sc, iters=30)
    assert rmse(sc) < 0.01


def test_ba_holds_fixed_when_masked():
    sc = _port_scene(ring_scene(n_views=6, n_points=50, seed=4), noise_X=0.01, seed=5)
    X0, R0 = sc.X.copy(), sc.pose_R.copy()
    _run(sc, iters=15, refine_rotation=False, refine_translation=False)
    np.testing.assert_allclose(sc.pose_R, R0, atol=1e-12)
    assert np.abs(sc.X - X0).max() > 1e-4
    assert rmse(sc) < 0.01


def test_ba_with_intrinsics_refinement():
    s = ring_scene(n_views=10, n_points=120, seed=6)
    sc = _port_scene(s, seed=7)
    p = np.asarray(sc.cameras.params).copy()
    p[0, 0] *= 1.02
    sc.cameras = sc.cameras._replace(params=p)
    assert rmse(sc) > 1.0
    _run(sc, iters=30, refine_intrinsics=tba.ADJUST_ALL)
    assert rmse(sc) < 0.05
    assert abs(float(sc.cameras.params[0, 0]) - s.K[0, 0, 0]) / s.K[0, 0, 0] < 0.002


def test_ba_huber_rejects_outliers():
    s = ring_scene(n_views=8, n_points=80, seed=8)
    sc = _port_scene(s, noise_X=0.01, seed=9)
    rng = np.random.default_rng(10)
    n = len(sc.obs_x)
    bad = rng.choice(n, n // 20, replace=False)
    sc.obs_x[bad] += rng.uniform(50, 200, size=(len(bad), 2))
    sc2 = _port_scene(s, noise_X=0.01, seed=9)
    sc2.obs_x[bad] = sc.obs_x[bad]
    _run(sc, iters=30)
    _run(sc2, iters=30, use_huber=False)
    good = np.setdiff1d(np.arange(n), bad)
    e1 = np.linalg.norm(reprojection_residuals(sc)[0], axis=1)
    e2 = np.linalg.norm(reprojection_residuals(sc2)[0], axis=1)
    assert np.median(e1[good]) < 0.5
    assert np.median(e1[good]) < np.median(e2[good])
