"""The port's ground-truth loaders (openmvg_torch/io/gt_loaders.py) against
the reference's on the fixture files of tests/test_gms_gt_loaders.py and
on multi-view variants: Middlebury, ETH3D, KITTI, DTU (through the port's
krt_from_P), BlendedMVS and Multiface give equal scenes."""

import os

import numpy as np
import pytest

from openmvg_tpu.io import gt_loaders as jgt
from openmvg_torch.io import gt_loaders as tgt


def _random_KRC(seed):
    rng = np.random.default_rng(seed)
    K = np.array([[800.0 + seed, 0, 320], [0, 800 + seed, 240], [0, 0, 1]])
    aa = rng.normal(size=3) * 0.3
    th = np.linalg.norm(aa)
    k = aa / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    return K, R, rng.normal(size=3)


def _rows(M):
    return "".join(" ".join(str(x) for x in row) + "\n" for row in M)


def write_middlebury(d):
    lines = ["3"]
    for i in range(3):
        K, R, C = _random_KRC(i)
        vals = list(K.reshape(-1)) + list(R.reshape(-1)) + list(-R @ C)
        lines.append(f"v{i}.png " + " ".join(str(v) for v in vals))
    p = os.path.join(d, "gt.txt")
    with open(p, "w") as f:
        f.write("\n".join(lines))
    return dict(filename=p)


def write_eth3d(d):
    with open(os.path.join(d, "cameras.txt"), "w") as f:
        f.write("# comment\n1 PINHOLE 640 480 500 510 320 240\n"
                "2 SIMPLE_PINHOLE 800 600 700 400 300\n")
    with open(os.path.join(d, "images.txt"), "w") as f:
        f.write("# comment\n1 1 0 0 0 0.5 0.5 1.0 1 img0.png\n"
                "2 0.9 0.1 -0.3 0.2 1.0 -2.0 0.5 2 img1.png\n")
    return dict(gt_dir=d)


def write_kitti(d):
    with open(os.path.join(d, "00.txt"), "w") as f:
        f.write("1 0 0 0.5 0 1 0 0 0 0 1 2\n0 0 1 3 0 1 0 1 -1 0 0 4\n")
    with open(os.path.join(d, "calib.txt"), "w") as f:
        f.write("P0: 700 0 600 0 0 700 180 0 0 0 1 0\n")
    return dict(gt_dir=d)


def write_dtu(d):
    for i, name in enumerate(("pos_017.txt", "pos_023.txt")):
        K, R, C = _random_KRC(3 + i)
        sign = -1.0 if i else 1.0        # a P of negative det is the same camera
        with open(os.path.join(d, name), "w") as f:
            f.write(_rows(sign * K @ np.concatenate([R, (-R @ C)[:, None]], 1)))
    return dict(gt_dir=d)


def write_blendedmvs(d):
    for i in range(2):
        K, R, C = _random_KRC(4 + i)
        E = np.eye(4)
        E[:3, :3], E[:3, 3] = R, -R @ C
        with open(os.path.join(d, f"0000001{i}_cam.txt"), "w") as f:
            f.write("extrinsic\n" + _rows(E) + "\nintrinsic\n" + _rows(K) + "\n425.0 2.5\n")
    return dict(gt_dir=d)


def write_multiface(d):
    with open(os.path.join(d, "KRT"), "w") as f:
        for i in range(2):
            K, R, C = _random_KRC(5 + i)
            t = -R @ C
            f.write(f"40000{i}\n" + _rows(K) + "0 0\n"
                    + "".join(" ".join(str(x) for x in R[r]) + f" {t[r]}\n" for r in range(3))
                    + "\n")
    return dict(gt_dir=d)


CASES = {"middlebury": write_middlebury, "eth3d": write_eth3d, "kitti": write_kitti,
         "dtu": write_dtu, "blendedmvs": write_blendedmvs, "multiface": write_multiface}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loader_equal_scene(name, tmp_path):
    kw = CASES[name](str(tmp_path))
    fn = f"load_{name}_gt"
    a, b = getattr(tgt, fn)(**kw), getattr(jgt, fn)(**kw)
    assert a.n_views == b.n_views >= 1
    assert list(a.view_filename) == list(b.view_filename)
    for f in ("view_intrinsic", "view_pose", "view_wh", "pose_valid"):
        assert np.array_equal(getattr(a, f), np.asarray(getattr(b, f))), f
    for f in ("pose_R", "pose_C"):
        np.testing.assert_allclose(getattr(a, f), np.asarray(getattr(b, f)), rtol=0,
                                   atol=1e-9, err_msg=f)
    np.testing.assert_allclose(a.cameras.params, np.asarray(b.cameras.params), atol=1e-9)
    assert np.array_equal(a.cameras.kind, np.asarray(b.cameras.kind))


def test_multiface_keeps_listed_images(tmp_path):
    write_multiface(str(tmp_path))
    a = tgt.load_multiface_gt(str(tmp_path), image_names={"400001.png"})
    b = jgt.load_multiface_gt(str(tmp_path), image_names={"400001.png"})
    assert a.view_filename == b.view_filename == ["400001.png"]
