"""Port parity for the main path's other output files: sfm_data .bin and
.xml, scene snapshots, the reconstruction report and the eval HTML.

The .bin writer is held to the handcrafted cereal PortableBinary streams
of tests/test_cereal_golden.py; on a ring scene with GPS priors, control
points and all six camera models, each package's .json/.bin/.xml writer
gives the same bytes and each package reads the other's files back to the
same records (exact: every number crosses as a float64).  The HTML files
are compared byte for byte.
"""

import numpy as np
import pytest

from openmvg_tpu.io import sfm_data as jsfm
from openmvg_tpu.io import snapshot as jsnap
from openmvg_tpu.models import cameras as jcm
from openmvg_tpu.sfm.eval_quality import export_eval_html as jexport_eval_html
from openmvg_tpu.sfm.scene import Scene as JScene
from openmvg_tpu.utils import report as jreport
from openmvg_tpu.utils.synthetic import ring_scene
from openmvg_torch.io import from_reference
from openmvg_torch.io import sfm_data as tsfm
from openmvg_torch.io import snapshot as tsnap
from openmvg_torch.io.sfm_data_bin import load_sfm_data_bin, save_sfm_data_bin
from openmvg_torch.models import cameras as tcm
from openmvg_torch.sfm.eval_quality import evaluate_against_gt, export_eval_html
from openmvg_torch.utils import report as treport
from tests.test_cereal_golden import f64, golden_sfm_bytes, s, tiny_scene, u8, u32, u64, vec

_FIELDS = ("view_intrinsic", "view_pose", "view_wh", "pose_valid", "pose_R", "pose_C", "X",
           "X_valid", "obs_landmark", "obs_view", "obs_x", "obs_feat", "obs_valid", "cp_X",
           "cp_obs_landmark", "cp_obs_view", "cp_obs_x", "cp_obs_feat", "prior_center",
           "prior_center_weight")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_same_scene(a, b, fields=_FIELDS):
    assert a.root_path == b.root_path and list(a.view_filename) == list(b.view_filename)
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f)
    for f in ("kind", "width", "height", "params"):
        np.testing.assert_array_equal(np.asarray(getattr(a.cameras, f)),
                                      np.asarray(getattr(b.cameras, f)), err_msg=f)


def ring_reference_scene():
    """The reference's Scene of an 8-view ring: six intrinsics, one per
    camera model, a view without a pose, GPS priors on two views, sparse
    landmark ids and two control points."""
    s_ = ring_scene(n_views=8, n_points=40, seed=3)
    rng = np.random.default_rng(7)
    V = s_.n_views
    kinds = [jcm.PINHOLE, jcm.PINHOLE_RADIAL_K1, jcm.PINHOLE_RADIAL_K3, jcm.PINHOLE_BROWN,
             jcm.PINHOLE_FISHEYE, jcm.SPHERICAL]
    params = np.zeros((6, jcm.MAX_PARAMS))
    params[:, :3] = [[1000.0 + 7 * i, 500.25, 499.5] for i in range(6)]
    params[1, 3] = -0.05
    params[2, 3:6] = [0.1, -0.02, 0.003]
    params[3, 3:8] = [0.01, -0.002, 0.0005, 1e-4, -2e-4]
    params[4, 3:7] = [0.02, 0.001, -0.0003, 4e-5]
    params[5, :] = 0.0
    sc = JScene(root_path="/data/ring")
    sc.view_filename = [f"img_{v:02d}.jpg" for v in range(V)]
    sc.view_intrinsic = np.asarray([0, 1, 2, 3, 4, 5, 0, 2], np.int32)
    sc.view_pose = np.arange(V, dtype=np.int32)
    sc.view_wh = np.tile([[1000, 1000]], (V, 1)).astype(np.int32)
    sc.cameras = jcm.Cameras(kind=np.asarray(kinds, np.int32), width=np.full(6, 1000.0),
                             height=np.full(6, 1000.0), params=params)
    sc.pose_valid = np.ones(V, bool)
    sc.pose_valid[5] = False
    sc.pose_R, sc.pose_C = s_.R.copy(), s_.C.copy()
    sc.prior_center = np.zeros((V, 3))
    sc.prior_center_weight = np.zeros((V, 3))
    sc.prior_center[[1, 6]] = rng.normal(size=(2, 3)) * 1e6
    sc.prior_center_weight[[1, 6]] = [[1.0, 1.0, 2.0], [0.5, 0.5, 0.5]]
    ov, ol = np.nonzero(s_.visible)
    sc.X = s_.X.copy()
    sc.X_valid = np.ones(s_.n_points, bool)
    sc.X_valid[::7] = False
    sc.obs_view, sc.obs_landmark = ov.astype(np.int32), ol.astype(np.int32)
    sc.obs_x = s_.x[ov, ol] + rng.normal(scale=0.3, size=(len(ov), 2))
    sc.obs_feat = rng.integers(0, 5000, len(ov)).astype(np.int32)
    sc.obs_valid = sc.X_valid[ol].copy()
    sc.cp_X = rng.normal(size=(2, 3))
    sc.cp_obs_landmark = np.asarray([0, 0, 1], np.int32)
    sc.cp_obs_view = np.asarray([0, 3, 2], np.int32)
    sc.cp_obs_x = rng.uniform(0, 1000, (3, 2))
    sc.cp_obs_feat = np.zeros(3, np.int32)
    return sc


def test_from_reference_carries_every_field():
    """Control points, priors and all six camera models come across."""
    ref = ring_reference_scene()
    port = from_reference(ref)
    _assert_same_scene(port, ref)
    assert sorted(int(k) for k in port.cameras.kind) == sorted(tcm.KIND_NAMES)


def test_bin_writer_reproduces_golden_stream(tmp_path):
    path = str(tmp_path / "sfm_data.bin")
    save_sfm_data_bin(from_reference(tiny_scene()), path)
    assert _bytes(path) == golden_sfm_bytes()


def test_bin_reader_parses_golden_stream(tmp_path):
    path = str(tmp_path / "sfm_data.bin")
    with open(path, "wb") as f:
        f.write(golden_sfm_bytes())
    sc = load_sfm_data_bin(path)
    ref = tiny_scene()
    assert sc.root_path == "/data" and sc.view_filename == ref.view_filename
    np.testing.assert_array_equal(sc.view_intrinsic, ref.view_intrinsic)
    np.testing.assert_array_equal(sc.view_pose, ref.view_pose)
    np.testing.assert_array_equal(sc.prior_center[1], [1.0, 2.0, 3.0])
    assert np.all(sc.prior_center_weight[0] == 0)
    assert list(sc.cameras.kind) == [tcm.PINHOLE, tcm.PINHOLE_RADIAL_K3]
    np.testing.assert_array_equal(sc.cameras.params, ref.cameras.params)
    np.testing.assert_array_equal(sc.pose_R[0], np.eye(3))
    np.testing.assert_array_equal(sc.pose_C[0], [0.5, -0.25, 2.0])
    assert sc.X_valid[7] and not sc.X_valid[:7].any()
    np.testing.assert_array_equal(sc.X[7], [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(sc.obs_feat, [4, 9])
    np.testing.assert_array_equal(sc.obs_x, ref.obs_x)


def test_bin_reader_accepts_permuted_entry_order(tmp_path):
    """The reference's unordered_maps may write entries in any order; the
    type indices then bind to whichever entry came first."""
    MSB, MSB2 = 0x80000000, 0x40000000
    view1 = (u32(1) + u32(MSB | 1) + s("view_priors") + u32(MSB | 1) + s("") + s("img1.jpg")
             + u32(640) + u32(480) + u32(1) + u32(1) + u32(0xFFFFFFFF)
             + u8(1) + vec(1.0, 1.0, 1.0) + vec(1.0, 2.0, 3.0))
    view0 = (u32(0) + u32(MSB2) + u32(MSB | 2) + s("") + s("img0.jpg") + u32(640) + u32(480)
             + u32(0) + u32(0) + u32(0))
    intr1 = (u32(1) + u32(MSB | 2) + s("pinhole_radial_k3") + u32(MSB | 3) + u32(640)
             + u32(480) + f64(520.0) + vec(321.0, 241.0) + vec(0.1, -0.05, 0.01))
    intr0 = (u32(0) + u32(MSB | 3) + s("pinhole") + u32(MSB | 4) + u32(640) + u32(480)
             + f64(500.0) + vec(320.0, 240.0))
    path = str(tmp_path / "sfm_data.bin")
    with open(path, "wb") as f:
        f.write(u8(1) + s("0.3") + s("/data") + u64(2) + view1 + view0 + u64(2) + intr1
                + intr0 + u64(0) + u64(0) + u64(0))
    sc = load_sfm_data_bin(path)
    assert sc.view_filename == ["img0.jpg", "img1.jpg"]
    assert list(sc.cameras.kind) == [tcm.PINHOLE, tcm.PINHOLE_RADIAL_K3]
    np.testing.assert_array_equal(sc.view_pose, [0, -1])
    np.testing.assert_array_equal(sc.prior_center[1], [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(sc.cameras.params[1, :6], [520.0, 321.0, 241.0, 0.1, -0.05,
                                                             0.01])


def test_bin_repeated_type_uses_bare_index(tmp_path):
    """A second pinhole intrinsic refers to its type by the bare index,
    without the name (cereal registerPolymorphicType)."""
    sc = from_reference(tiny_scene())
    params = np.zeros((2, tcm.MAX_PARAMS))
    params[:, :3] = [[500.0, 320.0, 240.0], [520.0, 321.0, 241.0]]
    sc.cameras = tcm.Cameras(kind=np.asarray([tcm.PINHOLE, tcm.PINHOLE], np.int32),
                             width=np.full(2, 640.0), height=np.full(2, 480.0), params=params)
    path = str(tmp_path / "sfm_data.bin")
    save_sfm_data_bin(sc, path)
    assert _bytes(path).count(s("pinhole")) == 1
    back = load_sfm_data_bin(path)
    assert list(back.cameras.kind) == [tcm.PINHOLE, tcm.PINHOLE]
    np.testing.assert_array_equal(back.cameras.params, params)


@pytest.mark.parametrize("ext", [".json", ".bin", ".xml"])
def test_ring_scene_bytes_and_cross_read(tmp_path, ext):
    """Both writers give the same bytes; each package reads the other's
    file to the same records; the port reads its own file back to what
    the reference reads."""
    ref = ring_reference_scene()
    pj, pt = str(tmp_path / ("j" + ext)), str(tmp_path / ("t" + ext))
    jsfm.save_sfm_data(ref, pj)
    tsfm.save_sfm_data(from_reference(ref), pt)
    assert _bytes(pj) == _bytes(pt)
    back_t = tsfm.load_sfm_data(pj)
    back_j = jsfm.load_sfm_data(pt)
    _assert_same_scene(back_t, from_reference(back_j))
    assert int(back_t.pose_valid.sum()) == 7 and back_t.n_landmarks == ref.n_landmarks
    np.testing.assert_array_equal(back_t.cp_X, ref.cp_X)
    np.testing.assert_array_equal(back_t.prior_center[[1, 6]], ref.prior_center[[1, 6]])


@pytest.mark.parametrize("part", ["VIEWS", "INTRINSICS", "EXTRINSICS", "STRUCTURE",
                                  "CONTROL_POINTS"])
def test_part_flags_match_reference(tmp_path, part):
    """A file of one part (convert's -V/-I/-E/-S/-C) is the reference's,
    and both packages read only that part of a whole file alike."""
    ref = ring_reference_scene()
    bit = getattr(tsfm, part)
    assert bit == getattr(jsfm, part)
    for ext in (".json", ".bin"):
        pj, pt = str(tmp_path / ("j" + ext)), str(tmp_path / ("t" + ext))
        jsfm.save_sfm_data(ref, pj, bit)
        tsfm.save_sfm_data(from_reference(ref), pt, bit)
        assert _bytes(pj) == _bytes(pt)
        whole = str(tmp_path / ("w" + ext))
        jsfm.save_sfm_data(ref, whole)
        _assert_same_scene(tsfm.load_sfm_data(whole, bit),
                           from_reference(jsfm.load_sfm_data(whole, bit)))


def test_snapshot_crosses_both_ways(tmp_path):
    ref = ring_reference_scene()
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jsnap.save_snapshot(ref, pj)
    tsnap.save_snapshot(from_reference(ref), pt)
    _assert_same_scene(tsnap.load_snapshot(pj), ref)
    _assert_same_scene(from_reference(jsnap.load_snapshot(pt)), ref)
    ref.prior_center = ref.prior_center_weight = None   # a snapshot without priors
    tsnap.save_snapshot(from_reference(ref), pt)
    _assert_same_scene(from_reference(jsnap.load_snapshot(pt[:-4])), ref)


@pytest.mark.parametrize("stage_times", [{}, {"bundle_adjustment": 3.25, "resection": 1.5,
                                               "f64_polish": 0.125}])
def test_sfm_report_bytes(tmp_path, stage_times):
    ref = ring_reference_scene()
    pj, pt = str(tmp_path / "j.html"), str(tmp_path / "t.html")
    jreport.generate_sfm_report(ref, pj, stage_times=stage_times)
    treport.generate_sfm_report(from_reference(ref), pt, stage_times=stage_times)
    assert _bytes(pj) == _bytes(pt)
    assert b"Residual norm histogram" in _bytes(pt)


def test_eval_html_bytes(tmp_path):
    ref = ring_reference_scene()
    est = from_reference(ref)
    gt = from_reference(ref)
    est.pose_C = est.pose_C * 1.5 + np.random.default_rng(0).normal(scale=1e-3, size=(8, 3))
    stats = evaluate_against_gt(est, gt)
    assert stats["ok"] and stats["n_common"] == 7
    pj, pt = str(tmp_path / "j.html"), str(tmp_path / "t.html")
    jexport_eval_html(stats, pj)
    export_eval_html(stats, pt)
    assert _bytes(pj) == _bytes(pt)
    jexport_eval_html({"ok": False, "n_common": 1}, pj)
    export_eval_html({"ok": False, "n_common": 1}, pt)
    assert _bytes(pj) == _bytes(pt)
