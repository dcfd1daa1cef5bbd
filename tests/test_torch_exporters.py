"""The port's exporters (openmvg_torch/io/exporters.py, the CLI's export)
against the reference's on the same scene: every format byte-equal,
except the undistorted images, which are compared in pixels within 1 gray
level.  The scene is a 6-view ring of 40 points with a radial-K3 camera
of small distortion and a rendered PNG per view."""

import os
import shutil

import numpy as np
import pytest

from openmvg_tpu import cli as jcli
from openmvg_tpu.io import exporters as jexp
from openmvg_tpu.io import image as jimage
from openmvg_tpu.io.sfm_data import save_sfm_data
from openmvg_tpu.models import cameras as jcm
from openmvg_tpu.utils.synthetic import ring_scene
from openmvg_torch import cli
from openmvg_torch.io import exporters as texp
from openmvg_torch.io import from_reference
from openmvg_torch.io import image as timage
from tests.test_ba import scene_from_ring

DEV = ["--device", "cpu"]
SIZE = 96


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export")
    sc = scene_from_ring(ring_scene(n_views=6, n_points=40, seed=0), seed=1,
                         kind=jcm.PINHOLE_RADIAL_K3)
    sc.cameras = sc.cameras._replace(params=np.asarray(sc.cameras.params).copy())
    sc.cameras.params[0, 3:6] = [-0.05, 0.01, 0.0]
    sc.view_filename = [f"v{i}.png" for i in range(6)]
    sc.root_path = str(tmp)
    rng = np.random.default_rng(0)
    for name in sc.view_filename:   # smooth gray images of the scene's size
        small = rng.random((SIZE // 8 + 2, SIZE // 8 + 2))
        img = np.kron(small, np.ones((8, 8)))[:SIZE, :SIZE]
        timage.write_image(str(tmp / name), img)
    sc.view_wh = np.full((6, 2), SIZE, np.int32)
    sc.cameras = sc.cameras._replace(width=np.full(1, float(SIZE)),
                                     height=np.full(1, float(SIZE)))
    sc.cameras.params[0, :3] = [SIZE * 1.2, SIZE / 2, SIZE / 2]
    sp = str(tmp / "sfm_data.json")
    save_sfm_data(sc, sp)
    return tmp, sc, sp


def _tree(path):
    if os.path.isfile(path):
        with open(path, "rb") as f:
            return {"": f.read()}
    out = {}
    for d, _, fs in os.walk(path):
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), path)] = fh.read()
    return out


FORMATS = ["nvm", "colmap", "baf", "bundler", "pmvs", "mve", "openmvs", "agisoft", "meshlab",
           "mvstexturing", "cmpmvs", "frustums", "webgl", "json", "bin", "ply"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_export_format_byte_equal(scene_files, fmt):
    """export -f <fmt> through both CLIs to the same path in turn (cmpmvs
    writes its directory into its .ini files; baf also writes
    <out>_imgList.txt)."""
    tmp, _, sp = scene_files
    ext = {"json": ".json", "bin": ".bin", "ply": ".ply"}.get(fmt, "")
    parent = tmp / f"out_{fmt}"
    out = str(parent / f"scene{ext}")
    trees = []
    for main, extra in ((jcli.main, []), (cli.main, DEV)):
        os.makedirs(parent)
        assert main(["export", "-i", sp, "-o", out, "-f", fmt] + extra) == 0
        tree = _tree(str(parent))
        assert tree and all(len(v) for v in tree.values())
        trees.append(tree)
        shutil.rmtree(parent)
    assert trees[0] == trees[1]


def test_export_colored_and_unit_frustums(scene_files, tmp_path):
    """The writers' optional inputs: landmark colours (nvm, colmap, bundler,
    openmvs, webgl) and colourised frustums."""
    _, sc, _ = scene_files
    tsc = from_reference(sc)
    colors = np.random.default_rng(3).integers(0, 255, (40, 3))
    for name in ("export_nvm", "export_colmap", "export_bundler", "export_openmvs",
                 "export_webgl"):
        a, b = str(tmp_path / f"{name}_ref"), str(tmp_path / f"{name}_port")
        getattr(jexp, name)(sc, a, colors=colors)
        getattr(texp, name)(tsc, b, colors=colors)
        assert _tree(a) == _tree(b), name
    a, b = str(tmp_path / "fr_ref.ply"), str(tmp_path / "fr_port.ply")
    jexp.export_frustums_ply(sc, a, colorize=True)
    texp.export_frustums_ply(tsc, b, colorize=True)
    assert _tree(a) == _tree(b)


def test_export_undistorted_pixels(scene_files, tmp_path):
    """Undistorted images: with the gray loader both packages resample the
    same (within 1 gray level); the port's default path (RGB uint8 read,
    every channel resampled, PNG written) gives the same pixels in each
    channel.  The reference's own default reads (H, W, 3) and resamples its
    last two axes, so the comparison takes its gray path."""
    tmp, sc, sp = scene_files

    def gray_loader(path):
        return timage.read_image(path, grayscale=True)

    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    jexp.export_undistorted_images(sc, a, image_loader=gray_loader, writer=jimage.write_image)
    texp.export_undistorted_images(from_reference(sc), b, image_loader=gray_loader,
                                   device="cpu")
    c = str(tmp_path / "cli")
    assert cli.main(["export", "-i", sp, "-o", c, "-f", "undistorted"] + DEV) == 0
    for name in sc.view_filename:
        ra = timage.read_image(os.path.join(a, name)).astype(int)[..., 0]
        rb = timage.read_image(os.path.join(b, name)).astype(int)[..., 0]
        rc = timage.read_image(os.path.join(c, name)).astype(int)
        src = timage.read_image(os.path.join(tmp, name)).astype(int)[..., 0]
        assert np.abs(ra - rb).max() <= 1
        assert all(np.abs(rc[..., k] - ra).max() <= 1 for k in range(3))
        assert np.abs(ra - src).max() > 1     # the distortion moved the pixels
