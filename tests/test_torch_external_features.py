"""The external-features injection contract through the port: the
reference demo (examples/external_features_demo.py, openmvg_tpu.io) and
the port's (examples/external_features_demo_torch.py, openmvg_torch.io)
write the same .feat, .desc, image_describer.json and
matches.putative.bin, byte for byte, on one rendered scene, and the port's
CLI resumes from them (filter -g f)."""

import importlib.util
import os

import pytest

from openmvg_torch import cli
from openmvg_torch.utils.synthetic import render_textured_sphere_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _demo(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_both_demos_write_the_same_files(tmp_path):
    pytest.importorskip("PIL.Image")  # the reference demo reads images through PIL
    imgdir, *_ = render_textured_sphere_dataset(str(tmp_path), n_views=3, size=128,
                                                focal=153.6, seed=1, arc_step=0.06,
                                                device="cpu")
    out = str(tmp_path / "out")
    sfm = os.path.join(out, "sfm_data.json")
    assert cli.main(["init", "-i", imgdir, "-o", out, "-f", "153.6", "-c", "1",
                     "--device", "cpu"]) == 0
    dirs = {}
    for name in ("external_features_demo", "external_features_demo_torch"):
        dirs[name] = str(tmp_path / name)
        _demo(name).main(["-i", sfm, "-m", dirs[name], "-n", "128"])
    ref, got = dirs["external_features_demo"], dirs["external_features_demo_torch"]
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(got))
    assert sum(n.endswith(".feat") for n in names) == 3 and "matches.putative.bin" in names
    for n in names:
        with open(os.path.join(ref, n), "rb") as a, open(os.path.join(got, n), "rb") as b:
            assert a.read() == b.read(), n
    assert cli.main(["filter", "-i", sfm, "-m", os.path.join(got, "matches.putative.bin"),
                     "-o", os.path.join(got, "matches.f.bin"), "--device", "cpu"]) == 0
