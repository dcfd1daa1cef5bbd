"""The port's global SfM engine and its CLI on the CPU: openmvg_torch's
global_sfm on the reference's 8-view ring scene, held to the gates of
tests/test_global.py (every pose, more than 80 landmarks, reprojection
rmse < 0.3 px, trajectory error < 0.02 after 7-DoF alignment); a repeat
run; and `pipeline -s GLOBAL --device cpu` on rendered views, whose
sfm_data.json the reference reads and evaluates and writes back for the
port.

The reference's whole-engine runs take minutes on the CPU (its own
tests/test_global.py is marked slow), so the engine is compared with the
ground truth here and its components with the reference in
tests/test_torch_global.py.
"""

import os

import numpy as np
import pytest
import torch

from openmvg_tpu.io import sfm_data as jio
from openmvg_tpu.io.gt_loaders import load_strecha_gt as jload_gt
from openmvg_tpu.sfm.eval_quality import evaluate_against_gt as jevaluate
from openmvg_tpu.utils.synthetic import ring_scene
from openmvg_torch import cli
from openmvg_torch.io import from_reference
from openmvg_torch.io import sfm_data as tio
from openmvg_torch.io.gt_loaders import load_strecha_gt
from openmvg_torch.io.ply import load_ply_vertices
from openmvg_torch.sfm import pipeline_global as G
from openmvg_torch.sfm.eval_quality import evaluate_against_gt
from openmvg_torch.sfm.scene import rmse
from openmvg_torch.utils.synthetic import render_textured_sphere_dataset
from tests.test_torch_incremental import _ate_aligned, ring_data
from tests.test_torch_smatvec import k3_on_the_cpu


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs on several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("rot,trans", [
    (G.ROTATION_AVERAGING_L2, G.TRANSLATION_AVERAGING_SOFTL1),
    (G.ROTATION_AVERAGING_L1, G.TRANSLATION_AVERAGING_L1),
    (G.ROTATION_AVERAGING_L2, G.TRANSLATION_AVERAGING_L2_CHORDAL),
])
def test_global_sfm_on_ring_scene(rot, trans):
    s = ring_scene(n_views=8, n_points=120, seed=0)
    jsc, feats, matches = ring_data(s)
    sc = from_reference(jsc)
    stats = {}
    G.global_sfm(sc, feats, matches, G.GlobalConfig(rotation_averaging=rot,
                                                    translation_averaging=trans,
                                                    ransac_samples=512, ba_iterations=15),
                 seed=0, device="cpu", stats=stats)
    assert int(sc.pose_valid.sum()) == s.n_views
    assert sc.n_landmarks > 80
    assert rmse(sc) < 0.3
    assert _ate_aligned(sc.pose_C, s.C)[1] < 0.02
    assert stats["rounds"] >= 1 and stats["polish_steps"] >= 0


def test_global_same_seed_same_scene(monkeypatch):
    """Two runs on noisy features with the fused S-matvec (K3's plan put
    on each BA's problem) write the same scene bit for bit."""
    k3_on_the_cpu(monkeypatch)
    s = ring_scene(n_views=8, n_points=100, seed=3)
    out = []
    for _ in range(2):
        jsc, feats, matches = ring_data(s, noise_px=0.3, seed=4)
        sc = from_reference(jsc)
        G.global_sfm(sc, feats, matches, G.GlobalConfig(ransac_samples=256, ba_iterations=10),
                     seed=5, device="cpu")
        out.append(sc)
    a, b = out
    assert int(a.pose_valid.sum()) == s.n_views
    for f in ("pose_valid", "pose_R", "pose_C", "X", "X_valid", "obs_valid", "obs_landmark"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_cli_pipeline_global_on_rendered_views(tmp_path, capsys):
    """`pipeline -s GLOBAL --device cpu` (filter -g e, sfm -s GLOBAL,
    color) on 6 textured-sphere views of 160^2 (about 900 matches in all):
    every view posed, rmse < 1 px, position rmse under 1% of the 3.0 ring
    radius.  The reference reads the port's sfm_data.json and evaluates it
    to the port's numbers within 1e-9; the port reads back what the
    reference saves."""
    tmp = str(tmp_path)
    size, n = 160, 6
    imgdir, gtdir, _, _, _ = render_textured_sphere_dataset(
        tmp, n_views=n, size=size, focal=1.2 * size, seed=1, arc_step=0.063, device="cpu")
    run = os.path.join(tmp, "run")
    assert cli.main(["pipeline", "-i", imgdir, "-o", run, "-f", str(1.2 * size), "-c", "1",
                     "-p", "HIGH", "-s", "GLOBAL", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "-g e" in printed and "translation_averaging" in printed
    recon = os.path.join(run, "reconstruction_global")
    est = tio.load_sfm_data(os.path.join(recon, "sfm_data.json"))
    assert int(est.pose_valid.sum()) == n
    assert rmse(est) < 1.0
    st = evaluate_against_gt(est, load_strecha_gt(gtdir))
    assert st["ok"] and st["position_rmse"] < 0.03
    jsc = jio.load_sfm_data(os.path.join(recon, "sfm_data.json"))
    ref = jevaluate(jsc, jload_gt(gtdir))
    for k in ("n_common", "position_rmse", "rotation_error_mean_deg", "scale"):
        assert abs(st[k] - ref[k]) <= 1e-9 * (1 + abs(ref[k])), k
    path = os.path.join(tmp, "ref_sfm_data.json")
    jio.save_sfm_data(jsc, path)
    back = tio.load_sfm_data(path)
    np.testing.assert_allclose(back.pose_C[back.pose_valid], est.pose_C[est.pose_valid],
                               atol=1e-12)
    pts, _ = load_ply_vertices(os.path.join(recon, "colorized.ply"))
    assert len(pts) == est.n_landmarks + n
