"""`init` on EXIF-tagged JPEGs, the port against the reference: make,
model and focal length give the focal in pixels through the sensor
database, views group by camera, and with -P the GPS position becomes an
ECEF pose-centre prior with the -W weights.  Intrinsics, view groups and
priors agree within 1e-9 relative.  PIL writes the JPEGs (it is only on
machines that read JPEG); without it the test skips.
"""

import os

import numpy as np
import pytest

from openmvg_tpu import cli as jcli
from openmvg_tpu.io import sfm_data as jio
from openmvg_torch import cli
from openmvg_torch.io import sfm_data as tio

# (file, make, model, focal mm, GPS (lat dms, lat ref, lon dms, lon ref, alt)
# or None; None for make: no EXIF at all)
IMAGES = [
    ("a.jpg", "Canon", "Canon EOS 5D", 50.0, ((48.0, 51.0, 29.6), "N", (2.0, 17.0, 40.2), "E",
                                              35.5)),
    ("b.jpg", "Canon", "Canon EOS 5D", 50.0, ((48.0, 51.0, 30.1), "N", (2.0, 17.0, 41.0), "E",
                                              36.0)),
    ("c.jpg", "NIKON", "NIKON D90", 35.0, ((33.0, 51.0, 24.0), "S", (151.0, 12.0, 55.0), "W",
                                           12.0)),
    ("d.jpg", "Apple", "iPhone 12", 4.2, None),
    ("e.jpg", None, None, None, None),
]


def _write_jpegs(imgdir):
    Image = pytest.importorskip("PIL.Image")
    ExifTags = pytest.importorskip("PIL.ExifTags")
    os.makedirs(imgdir)
    rng = np.random.default_rng(0)
    for name, make, model, focal, gps in IMAGES:
        im = Image.fromarray(rng.integers(0, 256, (48, 64, 3)).astype(np.uint8))
        ex = Image.Exif()
        if make is not None:
            ex[0x010F], ex[0x0110], ex[0x920A] = make, model, focal
        if gps is not None:
            lat, lat_ref, lon, lon_ref, alt = gps
            ex.get_ifd(ExifTags.IFD.GPSInfo).update({1: lat_ref, 2: lat, 3: lon_ref, 4: lon,
                                                     6: alt})
        im.save(os.path.join(imgdir, name), exif=ex)


@pytest.mark.parametrize("group", ["1", "0"])
def test_init_reads_exif_like_the_reference(tmp_path, group):
    imgdir = str(tmp_path / "images")
    _write_jpegs(imgdir)
    args = ["init", "-i", imgdir, "-P", "-W", "1.0;2.0;0.5", "-g", group]
    assert cli.main(args + ["-o", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert jcli.main(args + ["-o", str(tmp_path / "j")]) == 0
    got = tio.load_sfm_data(str(tmp_path / "t" / "sfm_data.json"))
    ref = jio.load_sfm_data(str(tmp_path / "j" / "sfm_data.json"))
    np.testing.assert_array_equal(got.view_intrinsic, ref.view_intrinsic)
    np.testing.assert_array_equal(got.cameras.kind, ref.cameras.kind)
    np.testing.assert_allclose(got.cameras.params, ref.cameras.params, rtol=1e-9)
    np.testing.assert_allclose(got.prior_center, ref.prior_center, rtol=1e-9)
    np.testing.assert_array_equal(got.prior_center_weight, ref.prior_center_weight)
    # the default camera model; the EOS 5D focal from its 35.8 mm sensor
    assert set(got.cameras.kind.tolist()) == {3}
    np.testing.assert_allclose(got.cameras.params[got.view_intrinsic[0], 0],
                               64 * 50.0 / 35.8, rtol=1e-12)
    assert (got.cameras.params[got.view_intrinsic[4], 0] == 1.2 * 64)   # no EXIF: 1.2 max(w, h)
    assert len(got.cameras.kind) == (4 if group == "1" else 5)
    assert (got.prior_center_weight[:3] == [1.0, 2.0, 0.5]).all()
    assert not got.prior_center_weight[3:].any()
    assert np.linalg.norm(got.prior_center[0]) > 6.3e6
