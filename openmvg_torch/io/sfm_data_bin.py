"""Binary `sfm_data.bin`: cereal's PortableBinary archive of the scene
(counterpart: openmvg_tpu/io/sfm_data_bin.py; openMVG
sfm_data_io_cereal.cpp Save_Cereal / Load_Cereal with
cereal::PortableBinaryOutputArchive).  Byte-equal to the reference's
writer.

Encoding, little-endian throughout (cereal 1.x portable_binary.hpp and
types/{map,vector,string,polymorphic,memory}.hpp):

  archive header   u8 1 (the archive's is-little-endian flag)
  string           u64 size + bytes
  vector<T>        u64 size + elements (each nested vector has its own)
  map<K, V>        u64 size + (key, value) pairs
  shared_ptr<Base> u32 polymorphic id: 0x40000000 when the dynamic type is
                   the static one (no name); 0x80000000 | type index and
                   the name on a registered type's first use (indices
                   count from 1 per archive); the bare index afterwards.
                   Then u32 0x80000000 | n, n a per-archive pointer
                   counter from 1, and the payload.

Payloads, after version "0.3" and root_path: View (local_path, filename,
width, height, id_view, id_intrinsic, id_pose as u32), ViewPriors (View,
u8 1, center_weight, center; registered as "view_priors"), intrinsics
(width, height u32, focal f64, principal point and distortion vectors),
Pose3 (three size-tagged rotation rows, then the centre), Landmark (X, then
a map view id -> (id_feat u32, x)).

The reference's unordered_maps iterate in no defined order, so a whole
file is byte-defined only for a chosen order: the writer emits ascending
keys, and the reader takes entries in any order.
"""

import struct

import numpy as np

from openmvg_torch.io.sfm_data import (ALL, CONTROL_POINTS, EXTRINSICS, INTRINSICS,
                                       STRUCTURE, VIEWS, _DISTO_KEY, _PtrIds, has_prior)
from openmvg_torch.models import cameras as cm
from openmvg_torch.sfm.scene import Scene

_MSB = 0x80000000
_MSB2 = 0x40000000   # cereal's msb2_32bit: the dynamic type is the static one


class _Writer:
    def __init__(self):
        self.parts = []

    def u8(self, v):
        self.parts.append(struct.pack("<B", v))

    def u32(self, v):
        self.parts.append(struct.pack("<I", int(v) & 0xFFFFFFFF))

    def u64(self, v):
        self.parts.append(struct.pack("<Q", v))

    def f64(self, v):
        self.parts.append(struct.pack("<d", float(v)))

    def vec(self, arr):
        a = np.asarray(arr, "<f8").reshape(-1)
        self.u64(len(a))
        self.parts.append(a.tobytes())

    def s(self, text):
        b = text.encode()
        self.u64(len(b))
        self.parts.append(b)

    def poly_header(self, ids: _PtrIds, name):
        """A shared_ptr's preamble; name None: the static type."""
        if name is None:
            self.u32(_MSB2)
        else:
            pid, pname = ids.poly(name)
            self.u32(pid)
            if pname is not None:
                self.s(pname)
        self.u32(ids.ptr())   # a first-seen pointer: msb set, payload follows

    def landmarks(self, X, X_valid, obs_landmark, obs_view, obs_feat, obs_x, obs_valid):
        lms = np.nonzero(X_valid)[0]
        self.u64(len(lms))
        obs_by = {}
        for k in np.nonzero(obs_valid)[0]:
            obs_by.setdefault(int(obs_landmark[k]), []).append(k)
        for l in lms:
            self.u32(l)
            self.vec(X[l])
            obs = obs_by.get(int(l), [])
            self.u64(len(obs))
            for k in obs:
                self.u32(obs_view[k])
                self.u32(obs_feat[k])
                self.vec(obs_x[k])


class _Reader:
    def __init__(self, data):
        self.d = data
        self.pos = 0
        self.names = {}   # type index -> registered name

    def _unpack(self, fmt, size):
        (v,) = struct.unpack_from(fmt, self.d, self.pos)
        self.pos += size
        return v

    def u8(self):
        return self._unpack("<B", 1)

    def u32(self):
        return self._unpack("<I", 4)

    def u64(self):
        return self._unpack("<Q", 8)

    def f64(self):
        return self._unpack("<d", 8)

    def vec(self):
        n = self.u64()
        out = np.frombuffer(self.d, "<f8", count=n, offset=self.pos)
        self.pos += 8 * n
        return out

    def s(self):
        n = self.u64()
        out = self.d[self.pos:self.pos + n].decode()
        self.pos += n
        return out

    def poly_header(self):
        """The registered type name, or None for the static type.  A null
        or aliased pointer raises: SfM_Data's containers hold neither."""
        pid = self.u32()
        if pid == 0:
            raise ValueError("nullptr shared_ptr in sfm_data.bin")
        if pid == _MSB2:
            name = None
        elif pid & _MSB:
            name = self.s()
            self.names[pid & ~_MSB] = name
        else:
            name = self.names[pid]
        if not self.u32() & _MSB:
            raise ValueError("aliased shared_ptr in sfm_data.bin")
        return name

    def landmarks(self):
        """(keys, {key: X}, obs_landmark, obs_view, obs_feat, obs_x)."""
        keys, ol, ov, of, ox = [], [], [], [], []
        Xs = {}
        for _ in range(self.u64()):
            k = self.u32()
            Xs[k] = self.vec()
            for _ in range(self.u64()):
                ov.append(self.u32())
                of.append(self.u32())
                ox.append(self.vec())
                ol.append(k)
            keys.append(k)
        return keys, Xs, ol, ov, of, ox


def save_sfm_data_bin(scene: Scene, path: str, parts: int = ALL):
    w = _Writer()
    ids = _PtrIds()
    w.u8(1)
    w.s("0.3")
    w.s(scene.root_path)
    n_views = scene.n_views if parts & VIEWS else 0
    w.u64(n_views)
    for v in range(n_views):
        prior = has_prior(scene, v)
        w.u32(v)
        w.poly_header(ids, "view_priors" if prior else None)
        w.s("")   # local_path: filenames are relative to root_path
        w.s(scene.view_filename[v] if v < len(scene.view_filename) else "")
        for x in (scene.view_wh[v, 0], scene.view_wh[v, 1], v, scene.view_intrinsic[v],
                  scene.view_pose[v]):
            w.u32(x)
        if prior:
            w.u8(1)   # b_use_pose_center_
            w.vec(scene.prior_center_weight[v])
            w.vec(scene.prior_center[v])
    n_intr = scene.n_intrinsics if parts & INTRINSICS else 0
    w.u64(n_intr)
    cams = scene.cameras
    for i in range(n_intr):
        kind = int(cams.kind[i])
        w.u32(i)
        w.poly_header(ids, cm.KIND_NAMES[kind])
        w.u32(int(cams.width[i]))
        w.u32(int(cams.height[i]))
        if kind != cm.SPHERICAL:
            w.f64(cams.params[i, 0])
            w.vec(cams.params[i, 1:3])
            nd = _DISTO_KEY.get(kind, (None, 0))[1]
            if nd:
                w.vec(cams.params[i, 3:3 + nd])
    poses = np.nonzero(scene.pose_valid)[0] if parts & EXTRINSICS else []
    w.u64(len(poses))
    for p in poses:
        w.u32(p)
        w.u64(3)
        for row in scene.pose_R[p]:
            w.vec(row)
        w.vec(scene.pose_C[p])
    if parts & STRUCTURE:
        w.landmarks(scene.X, scene.X_valid, scene.obs_landmark, scene.obs_view,
                    scene.obs_feat, scene.obs_x, scene.obs_valid)
    else:
        w.u64(0)
    if parts & CONTROL_POINTS and len(scene.cp_X):
        w.landmarks(scene.cp_X, np.ones(len(scene.cp_X), bool), scene.cp_obs_landmark,
                    scene.cp_obs_view, scene.cp_obs_feat, scene.cp_obs_x,
                    np.ones(len(scene.cp_obs_landmark), bool))
    else:
        w.u64(0)
    with open(path, "wb") as f:
        f.write(b"".join(w.parts))
    return True


def _index(v):
    # openMVG's UndefinedIndexT (2^32 - 1) reads as -1
    return np.int32(v if v < 2**31 else -1)


def load_sfm_data_bin(path: str, parts: int = ALL) -> Scene:
    with open(path, "rb") as f:
        r = _Reader(f.read())
    if r.u8() != 1:
        raise ValueError("big-endian sfm_data.bin is not supported")
    version = r.s()
    if version < "0.3":
        raise ValueError(f"sfm_data.bin version {version} predates polymorphic views "
                         "(openMVG < 1.1); re-export it")
    scene = Scene(root_path=r.s())
    n = r.u64()
    if n:
        rows, priors = [], []
        for _ in range(n):
            key = r.u32()
            name = r.poly_header()
            local, fname = r.s(), r.s()
            rows.append((key, (local + "/" + fname) if local else fname,
                         r.u32(), r.u32(), r.u32(), r.u32(), r.u32()))
            if name == "view_priors" and r.u8():
                wgt = r.vec()
                priors.append((key, r.vec(), wgt))
        size = max(k for k, *_ in rows) + 1
        scene.view_filename = [""] * size
        scene.view_wh = np.zeros((size, 2), np.int32)
        scene.view_intrinsic = np.full(size, -1, np.int32)
        scene.view_pose = np.full(size, -1, np.int32)
        for k, name, wdt, hgt, _vid, iid, pid in rows:
            scene.view_filename[k] = name
            scene.view_wh[k] = [wdt, hgt]
            scene.view_intrinsic[k] = _index(iid)
            scene.view_pose[k] = _index(pid)
        if priors:
            scene.prior_center = np.zeros((size, 3))
            scene.prior_center_weight = np.zeros((size, 3))
            for k, c, wgt in priors:
                scene.prior_center[k] = c
                scene.prior_center_weight[k] = wgt
    if not parts & VIEWS:
        scene.view_filename = []
        scene.view_wh = np.zeros((0, 2), np.int32)
        scene.view_intrinsic = np.zeros(0, np.int32)
        scene.view_pose = np.zeros(0, np.int32)
    n = r.u64()
    if n:
        kind = np.zeros(n, np.int32)
        width, height = np.zeros(n), np.zeros(n)
        params = np.zeros((n, cm.MAX_PARAMS))
        for _ in range(n):
            k = r.u32()
            kd = cm.KIND_FROM_NAME.get(r.poly_header(), cm.PINHOLE)
            kind[k] = kd
            width[k] = r.u32()
            height[k] = r.u32()
            if kd != cm.SPHERICAL:
                params[k, 0] = r.f64()
                params[k, 1:3] = r.vec()
                nd = _DISTO_KEY.get(kd, (None, 0))[1]
                if nd:
                    params[k, 3:3 + nd] = r.vec()
        if parts & INTRINSICS:
            scene.cameras = cm.Cameras(kind=kind, width=width, height=height, params=params)
    rows = []
    for _ in range(r.u64()):
        k = r.u32()
        if r.u64() != 3:
            raise ValueError("malformed Pose3 rotation in sfm_data.bin")
        R = np.stack([r.vec() for _ in range(3)])
        rows.append((k, R, r.vec()))
    if not parts & EXTRINSICS:
        rows = []
    size = max([k for k, *_ in rows], default=-1) + 1
    if scene.n_views and len(scene.view_pose):
        size = max(size, int(scene.view_pose.max()) + 1)
    scene.pose_valid = np.zeros(size, bool)
    scene.pose_R = np.tile(np.eye(3), (size, 1, 1))
    scene.pose_C = np.zeros((size, 3))
    for k, R, C in rows:
        scene.pose_valid[k] = True
        scene.pose_R[k] = R
        scene.pose_C[k] = C
    keys, Xs, ol, ov, of, ox = r.landmarks()
    if keys and parts & STRUCTURE:
        size = max(keys) + 1
        scene.X = np.zeros((size, 3))
        scene.X_valid = np.zeros(size, bool)
        for k, X in Xs.items():
            scene.X[k] = X
            scene.X_valid[k] = True
        scene.obs_landmark = np.asarray(ol, np.int32)
        scene.obs_view = np.asarray(ov, np.int32)
        scene.obs_feat = np.asarray(of, np.int32)
        scene.obs_x = np.asarray(ox).reshape(-1, 2)
        scene.obs_valid = np.ones(len(ol), bool)
    keys, Xs, ol, ov, of, ox = r.landmarks()
    if keys and parts & CONTROL_POINTS:
        scene.cp_X = np.zeros((max(keys) + 1, 3))
        for k, X in Xs.items():
            scene.cp_X[k] = X
        scene.cp_obs_landmark = np.asarray(ol, np.int32)
        scene.cp_obs_view = np.asarray(ov, np.int32)
        scene.cp_obs_feat = np.asarray(of, np.int32)
        scene.cp_obs_x = np.asarray(ox).reshape(-1, 2) if ox else np.zeros((0, 2))
    return scene
