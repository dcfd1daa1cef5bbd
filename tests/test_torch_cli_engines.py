"""The port's CLI for the engines and files of this slice, on the CPU, on
6 rendered textured-sphere views of 160^2: `sfm -s INCREMENTALV2
--output_format bin` then `color` and `eval --html` reading the .bin,
`sfm -s STELLAR`, and `report`, `convert` and `points-filter`.  The
reference's `sfm` on the same inputs leaves the same file names, reads the
port's .bin and writes a report byte-equal to the port's for the same
scene and stage times.
"""

import os

import numpy as np
import pytest
import torch

from openmvg_tpu import cli as jcli
from openmvg_tpu.io import sfm_data as jio
from openmvg_tpu.utils import report as jreport
from openmvg_torch import cli
from openmvg_torch.io import sfm_data as tio
from openmvg_torch.io.gt_loaders import load_strecha_gt
from openmvg_torch.io.ply import load_ply_vertices
from openmvg_torch.sfm.eval_quality import evaluate_against_gt
from openmvg_torch.sfm.scene import rmse
from openmvg_torch.utils import report as treport
from openmvg_torch.utils.synthetic import render_textured_sphere_dataset

DEV = ["--device", "cpu"]
N, SIZE = 6, 160


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs on several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def front_end(tmp_path_factory):
    """init -c 1 .. filter f on the rendered views; (tmp, sfm_data.json,
    matches dir, ground-truth dir)."""
    tmp = str(tmp_path_factory.mktemp("cli_engines"))
    imgdir, gtdir, _, _, _ = render_textured_sphere_dataset(
        tmp, n_views=N, size=SIZE, focal=1.2 * SIZE, seed=1, arc_step=0.063, device="cpu")
    out, md = os.path.join(tmp, "out"), os.path.join(tmp, "matches")
    sfm = os.path.join(out, "sfm_data.json")
    for argv in (["init", "-i", imgdir, "-o", out, "-f", str(1.2 * SIZE), "-c", "1"],
                 ["features", "-i", sfm, "-o", md, "-p", "HIGH"],
                 ["pairs", "-i", sfm, "-o", os.path.join(md, "pairs.txt")],
                 ["matches", "-i", sfm, "-o", os.path.join(md, "matches.putative.bin"),
                  "-p", os.path.join(md, "pairs.txt")],
                 ["filter", "-i", sfm, "-m", os.path.join(md, "matches.putative.bin"),
                  "-o", os.path.join(md, "matches.f.bin")]):
        assert cli.main(argv + DEV) == 0, argv[0]
    return tmp, sfm, md, gtdir


def _check_scene(path, gtdir, max_pos):
    est = tio.load_sfm_data(path)
    assert int(est.pose_valid.sum()) == N
    assert rmse(est) < 1.0
    st = evaluate_against_gt(est, load_strecha_gt(gtdir))
    assert st["ok"] and st["position_rmse"] < max_pos
    return est


def test_cli_incremental_v2_bin_color_eval_html(front_end, capsys):
    """sfm -s INCREMENTALV2 --output_format bin writes sfm_data.bin, the
    PLY and the report; color and eval --html read the .bin; the
    reference's sfm leaves the same file names, and reads the port's .bin
    to the same poses."""
    tmp, sfm, md, gtdir = front_end
    recon = os.path.join(tmp, "recon_v2")
    assert cli.main(["sfm", "-i", sfm, "-m", md, "-o", recon, "-s", "INCREMENTALV2",
                     "--output_format", "bin"] + DEV) == 0
    assert "f64 polish steps" in capsys.readouterr().out
    written = sorted(os.listdir(recon))
    assert written == ["SfMReconstruction_Report.html", "cloud_and_poses.ply", "sfm_data.bin"]
    binp = os.path.join(recon, "sfm_data.bin")
    est = _check_scene(binp, gtdir, 0.03)
    ply, html = os.path.join(recon, "colorized.ply"), os.path.join(tmp, "eval.html")
    assert cli.main(["color", "-i", binp, "-o", ply] + DEV) == 0
    assert cli.main(["eval", "-i", binp, "-g", gtdir, "--html", html] + DEV) == 0
    pts, _ = load_ply_vertices(ply)
    assert len(pts) == est.n_landmarks + N
    with open(html) as f:
        assert f.read().count("<tr><td>") == N

    ref_recon = os.path.join(tmp, "recon_ref")
    assert jcli.main(["sfm", "-i", sfm, "-m", md, "-o", ref_recon, "-s", "INCREMENTALV2",
                      "--output_format", "bin", "-f", "ADJUST_NONE"]) == 0
    assert sorted(os.listdir(ref_recon)) == written
    back = jio.load_sfm_data(binp)
    np.testing.assert_array_equal(back.pose_C, est.pose_C)
    np.testing.assert_array_equal(back.X[back.X_valid], est.X[est.X_valid])
    pj, pt = os.path.join(tmp, "j.html"), os.path.join(tmp, "t.html")
    jreport.generate_sfm_report(back, pj, stage_times={"sfm": 1.0})
    treport.generate_sfm_report(est, pt, stage_times={"sfm": 1.0})
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()


def test_cli_stellar(front_end, capsys):
    """sfm -s STELLAR: every view posed, rmse < 1 px, position rmse under
    1% of the 3.0 ring radius, its stages in the stage table, no polish."""
    tmp, sfm, md, gtdir = front_end
    recon = os.path.join(tmp, "recon_stellar")
    assert cli.main(["sfm", "-i", sfm, "-m", md, "-o", recon, "-s", "STELLAR"] + DEV) == 0
    printed = capsys.readouterr().out
    assert " 0 f64 polish steps" in printed and " pods" in printed
    for name in ("relative_poses", "pods", "rotation_averaging", "translation_averaging",
                 "initial_structure", "staged_ba"):
        assert name in printed
    _check_scene(os.path.join(recon, "sfm_data.json"), gtdir, 0.03)
    assert os.path.exists(os.path.join(recon, "SfMReconstruction_Report.html"))


def test_cli_report_convert_points_filter(front_end):
    """report, convert (.json -> .bin -> .xml, and one part) and
    points-filter on an INCREMENTAL scene, each against the reference's
    command on the same input."""
    tmp, sfm, md, gtdir = front_end
    recon = os.path.join(tmp, "recon_v1")
    assert cli.main(["sfm", "-i", sfm, "-m", md, "-o", recon] + DEV) == 0
    src = os.path.join(recon, "sfm_data.json")
    scene = tio.load_sfm_data(src)

    rep = os.path.join(tmp, "report.html")
    assert cli.main(["report", "-i", src, "-o", rep] + DEV) == 0
    with open(rep) as f:
        assert f"<td>estimated poses</td><td>{N}</td>" in f.read()

    for ext, flags in ((".bin", []), (".xml", []), (".json", ["-E"]), (".bin", ["-V", "-S"])):
        tag = "".join(flags)
        pt, pj = (os.path.join(tmp, f"{who}{tag}{ext}") for who in ("t", "j"))
        assert cli.main(["convert", "-i", src, "-o", pt] + flags + DEV) == 0
        assert jcli.main(["convert", "-i", src, "-o", pj] + flags) == 0
        with open(pt, "rb") as a, open(pj, "rb") as b:
            assert a.read() == b.read(), (ext, flags)
    back = tio.load_sfm_data(os.path.join(tmp, "t.bin"))
    np.testing.assert_array_equal(back.pose_C, scene.pose_C)
    np.testing.assert_array_equal(back.X[back.X_valid], scene.X[scene.X_valid])

    for factor in ("5.2", "1.05"):
        pt, pj = os.path.join(tmp, f"tf{factor}.json"), os.path.join(tmp, f"jf{factor}.json")
        assert cli.main(["points-filter", "-i", src, "-o", pt, "-f", factor] + DEV) == 0
        assert jcli.main(["points-filter", "-i", src, "-o", pj, "-f", factor]) == 0
        with open(pt, "rb") as a, open(pj, "rb") as b:
            assert a.read() == b.read(), factor
    kept = tio.load_sfm_data(os.path.join(tmp, "tf1.05.json"))
    assert kept.n_landmarks < scene.n_landmarks
    assert kept.X_valid.all() and kept.obs_landmark.max() < kept.n_landmarks
