"""The port's CPU baselines (openmvg_torch/native.py, csrc/bench_native.cpp
built with -march=native) against the reference's (openmvg_tpu.native,
which Tier-1 builds): the 2-NN matcher gives equal indices and keep flags,
also from a build without AVX2; the LM step agrees in cost within 1e-10
relative (the reference merges its threads' partial sums in arrival order,
so its last bits vary) with the reference's step and with the port's own
f64 polish step at fixed intrinsics."""

import ctypes

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from openmvg_tpu import native as jnative
from openmvg_tpu.utils.synthetic import ring_scene
from openmvg_torch import native
from openmvg_torch.sfm import polish
from openmvg_torch.utils import build


def _descriptors(seed):
    """A (500, 128) and B (600, 128) uint8: half of A planted near a row of
    B (kept by the ratio test), the rest random, and duplicate rows of B
    (equal distances: the first index wins)."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 256, (600, 128)).astype(np.uint8)
    b[300:310] = b[200:210]
    a = rng.integers(0, 256, (500, 128)).astype(np.uint8)
    src = rng.choice(600, 250, replace=False)
    a[:250] = np.clip(b[src].astype(int) + rng.integers(-3, 4, (250, 128)), 0, 255)
    a[250:260] = b[200:210]
    return a, b


@pytest.mark.parametrize("scalar", [False, True], ids=["native", "no_avx2"])
def test_match_2nn_equals_the_reference(scalar):
    if not jnative.available():
        pytest.fail("the reference's native library did not build")
    a, b = _descriptors(1)
    if scalar:  # the same source built for x86-64 without AVX2
        flags = [f for f in build.BENCH_FLAGS if f != "-march=native"] + ["-mno-avx2"]
        lib, _ = build.build_shared("bench_native.cpp", build.gxx(), flags, deps=("native.cpp",))
        fn = lib.omt_bench_match_2nn
        i64 = ctypes.c_int64
        fn.restype = i64
        fn.argtypes = [ctypes.c_void_p, i64, ctypes.c_void_p, i64, i64, ctypes.c_double,
                       ctypes.c_void_p, ctypes.c_void_p]
        idx, keep = np.empty(len(a), np.int32), np.empty(len(a), np.int32)
        fn(a.ctypes.data, len(a), b.ctypes.data, len(b), a.shape[1], 0.8, idx.ctypes.data,
           keep.ctypes.data)
    else:
        idx, keep = native.bench_match_2nn(a, b, 0.8)
    ridx, rkeep = jnative.bench_match_2nn(a, b, 0.8)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(keep, rkeep)
    assert 200 < keep.sum() < len(a)  # the planted rows, less those with a duplicate


def _problem():
    sc = ring_scene(n_views=8, n_points=200, jitter=0.5, seed=3)
    v, p = np.nonzero(sc.visible)
    rng = np.random.default_rng(4)
    rotvec = np.ascontiguousarray(Rotation.from_matrix(np.asarray(sc.R)).as_rotvec())
    t = np.ascontiguousarray(np.asarray(sc.t, np.float64))
    X = np.ascontiguousarray(sc.X + rng.normal(scale=0.01, size=sc.X.shape))
    obs_x = np.asarray(sc.x, np.float64)[v, p]
    K = np.asarray(sc.K)[0]
    return (v.astype(np.int32), p.astype(np.int32), obs_x, rotvec, t, X,
            float(K[0, 0]), float(K[0, 2]), float(K[1, 2]))


def test_ba_lm_step_agrees_with_the_reference_and_the_polish():
    if not jnative.available():
        pytest.fail("the reference's native library did not build")
    obs_pose, obs_point, obs_x, rotvec, t, X, f, cx, cy = _problem()
    ours = [a.copy() for a in (rotvec, t, X)]
    ref = [a.copy() for a in (rotvec, t, X)]
    pol = [a.copy() for a in (rotvec, t, X)]
    ok, c0, c1 = native.bench_ba_lm_step(obs_pose, obs_point, obs_x, *ours, f, cx, cy)
    rok, r0, r1 = jnative.bench_ba_lm_step(obs_pose, obs_point, obs_x, *ref, f, cx, cy)
    kp = np.array([f, cx, cy])
    pok, p0, p1 = polish.ba_lm_step_k(obs_pose, obs_point, obs_x, *pol, kp, refine_k=False)
    assert ok and rok and pok and c1 < 0.9 * c0
    for other0, other1 in ((r0, r1), (p0, p1)):
        np.testing.assert_allclose([c0, c1], [other0, other1], rtol=1e-10)
    for x, y in zip(ours, ref):
        np.testing.assert_allclose(x, y, rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(kp, [f, cx, cy])


def test_bench_build_name_follows_the_source_it_includes(tmp_path):
    """bench_native.cpp includes native.cpp: a change to either renames the
    build, so the baselines never load a library of the old LM step."""
    import shutil

    d = str(tmp_path / "csrc")
    shutil.copytree(build.CSRC, d)
    flags = [f for f in build.BENCH_FLAGS if f != "-march=native"]
    before = build.build_tag("bench_native.cpp", flags, d, deps=("native.cpp",))
    with open(f"{d}/native.cpp", "a") as f:
        f.write("// a change to the LM step\n")
    assert build.build_tag("bench_native.cpp", flags, d, deps=("native.cpp",)) != before
