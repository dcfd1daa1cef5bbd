"""The port's CLI for the matching and filtering stages of this slice, on
the CPU, on 6 rendered textured-sphere views of 160^2, each command beside
the reference's on the same files: `matches -n CASCADEHASHINGL2` (other
hyperplanes, so held by overlap), `matches -n KDTREE` (the same bytes),
`filter -g h|a|u|o` and `filter -r` (the same pairs), `known-poses` on the
renderer's poses (the same landmarks), `vlad` (the same pairs when both
start from the same initial centres, through the kmeans_pp_init hook) and
`kvld-filter` (the same matches).
"""

import os

import numpy as np
import pytest
import torch

from openmvg_tpu import cli as jcli
from openmvg_tpu.ops import vlad as jvlad
from openmvg_torch import cli
from openmvg_torch.io import matches_io
from openmvg_torch.io import sfm_data as tio
from openmvg_torch.ops import vlad as tvlad
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
    """init -c 1 .. matches (brute force) on the rendered views; (tmp,
    sfm_data.json, matches dir, renderer's R and C)."""
    tmp = str(tmp_path_factory.mktemp("cli_matching"))
    imgdir, _, Rs, Cs, _ = render_textured_sphere_dataset(
        tmp, n_views=N, size=SIZE, focal=1.2 * SIZE, seed=1, arc_step=0.063, device="cpu")
    out, md = os.path.join(tmp, "out"), os.path.join(tmp, "matches")
    sfm = os.path.join(out, "sfm_data.json")
    for argv in (["init", "-i", imgdir, "-o", out, "-f", str(1.2 * SIZE), "-c", "1"],
                 ["features", "-i", sfm, "-o", md, "-p", "HIGH"],
                 ["pairs", "-i", sfm, "-o", os.path.join(md, "pairs.txt")],
                 ["matches", "-i", sfm, "-o", os.path.join(md, "matches.putative.bin"),
                  "-p", os.path.join(md, "pairs.txt")]):
        assert cli.main(argv + DEV) == 0, argv[0]
    return tmp, sfm, md, (np.asarray(Rs), np.asarray(Cs))


def _both(argv_t, argv_j):
    assert cli.main(argv_t + DEV) == 0
    assert jcli.main(argv_j) == 0


def _pairs(path):
    return matches_io.load_matches(path)


def test_cli_matches_cascade_and_kdtree(front_end):
    tmp, sfm, md, _ = front_end
    bf = _pairs(os.path.join(md, "matches.putative.bin"))
    for meth in ("CASCADEHASHINGL2", "KDTREE"):
        pt, pj = (os.path.join(md, f"matches.{meth}.{who}.bin") for who in ("t", "j"))
        _both(["matches", "-i", sfm, "-o", pt, "-n", meth],
              ["matches", "-i", sfm, "-o", pj, "-n", meth])
        if meth == "KDTREE":
            with open(pt, "rb") as a, open(pj, "rb") as b:
                assert a.read() == b.read()
            continue
        got, ref = _pairs(pt), _pairs(pj)
        mg = {(p, tuple(r)) for p, m in got.items() for r in m}
        mr = {(p, tuple(r)) for p, m in ref.items() for r in m}
        mb = {(p, tuple(r)) for p, m in bf.items() for r in m}
        assert len(mg & mr) >= 0.95 * len(mr)
        assert len(mg & mb) >= 0.9 * len(mb)
    # preemptive matching takes every method
    pt = os.path.join(md, "matches.pre.bin")
    assert cli.main(["matches", "-i", sfm, "-o", pt, "-n", "FASTCASCADEHASHINGL2",
                     "-P", "100"] + DEV) == 0
    assert len(_pairs(pt)) > 0


@pytest.mark.parametrize("model", ["h", "a", "u", "o", "f-r"])
def test_cli_filter_models_keep_the_reference_pairs(front_end, model):
    tmp, sfm, md, _ = front_end
    put = os.path.join(md, "matches.putative.bin")
    g = model[0]
    extra = ["-r"] if model == "f-r" else []
    pt, pj = (os.path.join(md, f"matches.{model}.{who}.bin") for who in ("t", "j"))
    common = ["filter", "-i", sfm, "-m", put, "-g", g, "--max_iteration", "256"] + extra
    _both(common + ["-o", pt], common + ["-o", pj])
    got, ref = _pairs(pt), _pairs(pj)
    assert sorted(got) == sorted(ref)
    if model in ("a", "f-r"):    # the ring is no plane and no ortho view: h, o keep less
        assert len(got) >= len(_pairs(put)) - 1
    if model == "f-r":
        plain = os.path.join(md, "matches.f.t.bin")
        assert cli.main(["filter", "-i", sfm, "-m", put, "-o", plain, "--max_iteration",
                         "256"] + DEV) == 0
        assert sum(map(len, got.values())) >= sum(map(len, _pairs(plain).values()))


def test_cli_known_poses_equals_reference(front_end):
    """known-poses on the renderer's poses (written into sfm_data.json):
    the same landmarks and observations, points to 1e-8."""
    tmp, sfm, md, (Rs, Cs) = front_end
    scene = tio.load_sfm_data(sfm)
    scene.pose_valid[:] = True
    scene.pose_R, scene.pose_C = Rs.copy(), Cs.copy()
    posed = os.path.join(tmp, "posed.json")
    tio.save_sfm_data(scene, posed)
    pt, pj = os.path.join(tmp, "kp_t.json"), os.path.join(tmp, "kp_j.json")
    _both(["known-poses", "-i", posed, "-m", md, "-o", pt],
          ["known-poses", "-i", posed, "-m", md, "-o", pj])
    a, b = tio.load_sfm_data(pt), tio.load_sfm_data(pj)
    assert a.n_landmarks == b.n_landmarks > 100
    for f in ("obs_landmark", "obs_view", "obs_feat"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_allclose(a.X, b.X, atol=1e-8)


def test_cli_vlad_equals_reference_from_the_same_centres(front_end, monkeypatch):
    tmp, sfm, md, _ = front_end

    def first_rows(_key, X, k):
        return X[:k]

    monkeypatch.setattr(jvlad, "kmeans_pp_init", first_rows)
    monkeypatch.setattr(tvlad, "kmeans_pp_init", first_rows)
    pt, pj = os.path.join(tmp, "vlad_t.txt"), os.path.join(tmp, "vlad_j.txt")
    args = ["vlad", "-i", sfm, "-m", md, "-k", "8", "-t", "2"]
    _both(args + ["-o", pt], args + ["-o", pj])
    with open(pt) as a, open(pj) as b:
        got = a.read()
        assert got == b.read()
    assert {int(x) for x in got.split()} == set(range(N))


def test_cli_kvld_filter_equals_reference(front_end):
    tmp, sfm, md, _ = front_end
    put = _pairs(os.path.join(md, "matches.putative.bin"))
    sub = os.path.join(md, "matches.sub.bin")
    matches_io.save_matches({p: put[p] for p in sorted(put)[:2]}, sub)
    pt, pj = os.path.join(md, "matches.kvld.t.bin"), os.path.join(md, "matches.kvld.j.bin")
    _both(["kvld-filter", "-i", sfm, "-m", sub, "-o", pt],
          ["kvld-filter", "-i", sfm, "-m", sub, "-o", pj])
    got, ref = _pairs(pt), _pairs(pj)
    assert sorted(got) == sorted(ref) and len(got) == 2
    for p in got:
        np.testing.assert_array_equal(got[p], ref[p])
