"""The port's small CLI tools against the reference's on one small scene
(a 6-view ring of 40 points, the scene of tests/test_cli_tools.py):
frustum-filter, change-origin, list-pairs, convert-matches (-a),
matches2tracks, split-matches, retrieval-quality and the SVG exports write
byte-equal files and print the same counts; the parsers agree on every
subcommand; a missing input file gives rc 1 and the same error line in
both; --profile writes a trace; refine reaches the same cost and rmse,
refine -d 2 (two gloo ranks on the CPU) that of refine -d 1, and matches
--ring_matching on over two ranks writes the file one rank writes."""

import argparse
import glob
import json
import os

import numpy as np
import pytest

from openmvg_tpu import cli as jcli
from openmvg_tpu.io.features_io import save_descs, save_feats
from openmvg_tpu.io.matches_io import save_matches
from openmvg_tpu.io.sfm_data import save_sfm_data
from openmvg_tpu.utils.synthetic import ring_scene
from openmvg_torch import cli
from openmvg_torch.io.sfm_data import load_sfm_data
from openmvg_torch.sfm.scene import rmse
from tests.test_ba import scene_from_ring

DEV = ["--device", "cpu"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The ring scene with GPS-like priors, a matches file of two
    components, and 20 features a view."""
    tmp = tmp_path_factory.mktemp("tools")
    sc = scene_from_ring(ring_scene(n_views=6, n_points=40, seed=0), noise_X=0.01,
                         noise_px=0.3, seed=1)
    sc.prior_center = sc.pose_C + np.random.default_rng(2).normal(scale=0.1, size=(6, 3))
    sc.prior_center_weight = np.ones((6, 3))
    sp = str(tmp / "sfm_data.json")
    save_sfm_data(sc, sp)
    m = {(0, 1): np.stack([np.arange(10)] * 2, 1), (1, 2): np.stack([np.arange(10)] * 2, 1),
         (3, 4): np.stack([np.arange(8)] * 2, 1), (4, 5): np.stack([np.arange(8)] * 2, 1)}
    mp = str(tmp / "matches.bin")
    save_matches(m, mp)
    mdir = tmp / "feats"
    mdir.mkdir()
    rng = np.random.default_rng(0)
    for v in range(sc.n_views):
        stem = os.path.splitext(sc.view_filename[v])[0]
        feats = np.concatenate([rng.uniform(0, 999, (20, 2)), rng.uniform(1, 4, (20, 1)),
                                np.zeros((20, 1))], 1)
        save_feats(str(mdir / f"{stem}.feat"), feats)
        save_descs(str(mdir / f"{stem}.desc"), np.zeros((20, 128), np.uint8))
    pf = str(tmp / "pairs.txt")
    with open(pf, "w") as f:
        f.write("0 1\n1 2\n0 5\n3 4\n")
    return tmp, sp, mp, str(mdir), pf


def _tree(path):
    """{relative name: bytes} of a file or of every file below a directory."""
    if os.path.isfile(path):
        with open(path, "rb") as f:
            return {"": f.read()}
    out = {}
    for d, _, fs in os.walk(path):
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), path)] = fh.read()
    return out


CASES = {
    "frustum-filter": lambda d, sp, mp, md, pf: (["frustum-filter", "-i", sp, "-o", d], d),
    "change-origin": lambda d, sp, mp, md, pf: (["change-origin", "-i", sp, "-o", d, "-f"], d),
    "change-origin-l": lambda d, sp, mp, md, pf: (
        ["change-origin", "-i", sp, "-o", d, "-l", "0.5;-1;2"], d),
    "list-pairs": lambda d, sp, mp, md, pf: (["list-pairs", "-i", sp, "-o", d], d),
    "list-pairs-V": lambda d, sp, mp, md, pf: (
        ["list-pairs", "-i", sp, "-o", d, "-V", "-d", "2"], d),
    "list-pairs-G": lambda d, sp, mp, md, pf: (
        ["list-pairs", "-i", sp, "-o", d, "-G", "-n", "2"], d),
    "convert-matches": lambda d, sp, mp, md, pf: (
        ["convert-matches", "-i", mp, "-o", d + ".txt", "-a", d + ".svg"], d),
    "matches2tracks": lambda d, sp, mp, md, pf: (["matches2tracks", "-i", mp, "-o", d], d),
    "split-matches": lambda d, sp, mp, md, pf: (["split-matches", "-i", mp, "-o", d + "/s.bin"],
                                                d),
    "export-keypoints": lambda d, sp, mp, md, pf: (
        ["export-keypoints", "-i", sp, "-d", md, "-o", d], d),
    "export-matches": lambda d, sp, mp, md, pf: (
        ["export-matches", "-i", sp, "-m", mp, "-d", md, "-o", d], d),
    "export-tracks": lambda d, sp, mp, md, pf: (
        ["export-tracks", "-i", sp, "-m", mp, "-d", md, "-o", d], d),
    "retrieval-quality": lambda d, sp, mp, md, pf: (
        ["retrieval-quality", "-i", sp, "-p", pf], None),
    "retrieval-quality-g": lambda d, sp, mp, md, pf: (
        ["retrieval-quality", "-p", pf, "-g", mp], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tool_outputs_equal(files, case, capsys):
    tmp, sp, mp, md, pf = files
    outs, printed = [], []
    for side, main, extra in (("ref", jcli.main, []), ("port", cli.main, DEV)):
        d = str(tmp / f"{case}_{side}")
        argv, out = CASES[case](d, sp, mp, md, pf)
        if case in ("split-matches",):
            os.makedirs(d, exist_ok=True)
        capsys.readouterr()
        assert main(argv + extra) == 0
        printed.append(capsys.readouterr().out.replace(d, "<out>"))
        if out is None:
            outs.append(None)
        else:
            tree = _tree(out)
            for suffix in (".txt", ".svg"):
                if os.path.exists(d + suffix):
                    tree[suffix] = _tree(d + suffix)[""]
            assert tree
            outs.append(tree)
    assert outs[0] == outs[1]
    assert printed[0] == printed[1]


def test_retrieval_quality_counts(files, capsys):
    """The printed counts equal those computed from the files: every view
    pair of the ring co-observes a point (15 pairs), 3 of the 4 listed."""
    _, sp, _, _, pf = files
    capsys.readouterr()
    assert cli.main(["retrieval-quality", "-i", sp, "-p", pf] + DEV) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["gt_pairs"] == 15 and out["true_positive"] == 4


def _reference_parser():
    """The reference's parser, taken from its main() as it parses."""
    class Got(Exception):
        pass

    orig = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        raise Got(self)

    argparse.ArgumentParser.parse_args = grab
    try:
        jcli.main(["init"])
    except Got as g:
        return g.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig


def _options(parser):
    return {tuple(a.option_strings): (a.default, a.required, a.nargs, a.type, a.choices)
            for a in parser._actions if a.option_strings and a.dest not in ("help", "device")}


def _subparsers(parser):
    return next(a for a in parser._actions
                if isinstance(a, argparse._SubParsersAction)).choices


def test_parser_matches_reference():
    ref, port = _reference_parser(), cli.build_parser()
    assert _options(ref) == _options(port)          # --profile
    rsub, psub = _subparsers(ref), _subparsers(port)
    assert set(rsub) == set(psub)
    for name, p in psub.items():
        assert _options(rsub[name]) == _options(p), name
        assert any(a.dest == "device" for a in p._actions), name


def test_missing_file_rc_1_and_message(tmp_path, capsys):
    missing = str(tmp_path / "nope.json")
    lines = []
    for main, extra in ((jcli.main, []), (cli.main, DEV)):
        capsys.readouterr()
        assert main(["list-pairs", "-i", missing, "-o", str(tmp_path / "p.txt")] + extra) == 1
        lines.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert lines[0] == lines[1] == f"error: file not found: {missing}"


def test_profile_writes_a_trace(files, tmp_path, monkeypatch):
    """--profile DIR (and OMT_PROFILE_DIR) write a Chrome trace that names
    the refine command's bundle_adjustment stage."""
    _, sp, _, _, _ = files
    prof = str(tmp_path / "prof")
    assert cli.main(["--profile", prof, "refine", "-i", sp, "-o", str(tmp_path / "r.json"),
                     "-n", "2"] + DEV) == 0
    traces = glob.glob(os.path.join(prof, "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert "bundle_adjustment" in f.read()
    env = str(tmp_path / "env")
    monkeypatch.setenv("OMT_PROFILE_DIR", env)
    assert cli.main(["list-pairs", "-i", sp, "-o", str(tmp_path / "p.txt")] + DEV) == 0
    assert len(glob.glob(os.path.join(env, "*.json"))) == 1


def test_refine_matches_reference(files, tmp_path, capsys):
    """refine (30 iterations) on the noisy ring: the same printed final
    cost (4 decimals, within 1e-6 relative) and rmse in both packages, and
    lower than before.  Both solve in float32 and stop once a step gains at
    most 1e-6 of the cost (ceres' function tolerance), so the two minima
    agree to that stopping rule and float32's resolution of the pixel
    residuals (eps 6e-8 x 500 px against an rmse of 0.35 px, 1e-4
    relative): rmse within 1e-5 relative."""
    _, sp, _, _, _ = files
    res = []
    for side, main, extra in (("ref", jcli.main, []), ("port", cli.main, DEV)):
        out = str(tmp_path / f"{side}.json")
        capsys.readouterr()
        assert main(["refine", "-i", sp, "-o", out] + extra) == 0
        text = capsys.readouterr().out
        cost = float(text.split("BA: cost=")[1].split()[0])
        res.append((cost, rmse(load_sfm_data(out))))
    (c0, r0), (c1, r1) = res
    assert abs(c1 - c0) <= 1e-6 * c0 + 1e-4
    assert abs(r1 - r0) <= 1e-5 * r0
    assert r1 < rmse(load_sfm_data(sp))


def test_refine_more_devices_raises(files, tmp_path, capsys):
    """refine -d 2 --device cpu: the point-sharded solve over two gloo
    ranks prints the reference's distributed line and reaches refine -d 1's
    cost within 1e-6 relative (it no longer raises).  Both solve in
    float32, the point sums in another order (K2's plain version against
    the point-major reshape-sums), so after 30 LM steps the centres (|C|
    about 2) and points agree to some tens of float32 ulps: within 1e-5."""
    _, sp, _, _, _ = files
    out = {}
    for d in ("1", "2"):
        capsys.readouterr()
        r = str(tmp_path / f"r{d}.json")
        assert cli.main(["refine", "-i", sp, "-o", r, "-d", d] + DEV) == 0
        text = capsys.readouterr().out
        key = "distributed BA over 2 devices: cost=" if d == "2" else "BA: cost="
        out[d] = (float(text.split(key)[1].split()[0]), load_sfm_data(r))
    assert "rank 1 (gloo) kernel launches" in text
    (c1, s1), (c2, s2) = out["1"], out["2"]
    assert abs(c2 - c1) <= 1e-6 * c1 + 5e-5           # 4 printed decimals
    np.testing.assert_allclose(s2.pose_C, s1.pose_C, rtol=0, atol=1e-5)
    np.testing.assert_allclose(s2.pose_R, s1.pose_R, rtol=0, atol=1e-5)
    np.testing.assert_allclose(s2.X, s1.X, rtol=0, atol=1e-5)


def test_matches_ring_two_ranks_writes_one_rank_file(files, tmp_path):
    """matches --ring_matching on, launched on two gloo ranks
    (runtime.spawn of runtime.run_cli), writes the file that matches
    writes on one rank, byte for byte, with the same printed summary."""
    from openmvg_torch.parallel import runtime

    tmp, sp, _, _, _ = files
    mdir = tmp_path / "feats"
    mdir.mkdir()
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (60, 128))
    sc = load_sfm_data(sp)
    for v in range(sc.n_views):
        stem = os.path.splitext(sc.view_filename[v])[0]
        n = 40 + 3 * v
        d = np.clip(base[:n] + rng.integers(-3, 4, (n, 128)), 0, 255).astype(np.uint8)
        save_descs(str(mdir / f"{stem}.desc"), d[rng.permutation(n)])
        save_feats(str(mdir / f"{stem}.feat"), np.zeros((n, 4)))
    argv = ["matches", "-i", sp, "-d", str(mdir), "--ring_matching", "on"] + DEV
    one, two = str(tmp_path / "one.bin"), str(tmp_path / "two.bin")
    assert cli.main(argv + ["-o", one]) == 0
    res = runtime.spawn(runtime.run_cli, 2, device="cpu", backend="gloo",
                        args=(argv + ["-o", two],), timeout=240, threads=1,
                        store=str(tmp_path / "store"))
    assert [r["rc"] for r in res] == [0, 0]
    assert "ring matching over 2 ranks" in res[0]["stdout"] and res[1]["stdout"] == ""
    with open(one, "rb") as f1, open(two, "rb") as f2:
        a, b = f1.read(), f2.read()
    assert a == b and len(a) > 100


def test_timer_and_progress_match_reference(caplog):
    """Progress logs the same lines as the reference's at every 10% of its
    items, and a logging Timer the same 'name: <seconds>s' line."""
    import logging

    from openmvg_torch.utils import logging as tlog
    from openmvg_tpu.utils import logging as jlog

    said = []
    for mod, name in ((jlog, "openmvg_tpu"), (tlog, "openmvg_torch")):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=name):
            p = mod.Progress(37, "tracks")
            for n in (1, 3, 2, 7, 1, 1, 9, 13):
                p.update(n)
            with mod.Timer("block", log=True) as t:
                pass
        lines = [r.getMessage() for r in caplog.records if r.name == name]
        assert lines[-1] == f"block: {t.elapsed:.3f}s" and t.elapsed >= 0
        said.append(lines[:-1])
    assert said[0] == said[1] and len(said[0]) == 5
