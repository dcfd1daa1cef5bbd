"""openMVG-compatible scene IO: cereal-JSON `sfm_data.json` read/write
(counterpart: openmvg_tpu/io/sfm_data.py; byte-compatible with its JSON).

Reference parity: sfm/sfm_data_io_cereal.cpp (version "0.3"),
sfm_view_io.hpp, cameras/*_io.hpp field names, geometry/pose3_io.hpp,
sfm_landmark_io.hpp.  The cereal polymorphic-pointer encoding is
reproduced: the first use of a type writes 0x80000000|index and its name,
later uses the plain index; plain View pointers use 1073741824; ptr_wrapper
ids count up from 2147483649.  load_sfm_data / save_sfm_data dispatch on
the extension: .json here, .bin to io/sfm_data_bin.py (cereal
PortableBinary), .xml to io/sfm_data_xml.py (cereal XML).
"""

import json
import os

import numpy as np

from openmvg_torch.models import cameras as cm
from openmvg_torch.sfm.scene import Scene

VIEWS = 1
INTRINSICS = 2
EXTRINSICS = 4
STRUCTURE = 8
CONTROL_POINTS = 16
ALL = VIEWS | INTRINSICS | EXTRINSICS | STRUCTURE | CONTROL_POINTS

_DISTO_KEY = {
    cm.PINHOLE_RADIAL_K1: ("disto_k1", 1),
    cm.PINHOLE_RADIAL_K3: ("disto_k3", 3),
    cm.PINHOLE_BROWN: ("disto_t2", 5),
    cm.PINHOLE_FISHEYE: ("fisheye", 4),
}


class _PtrIds:
    def __init__(self):
        self.next_ptr = 2147483649
        self.type_index = {}

    def ptr(self):
        v = self.next_ptr
        self.next_ptr += 1
        return v

    def poly(self, name):
        if name in self.type_index:
            return self.type_index[name], None
        idx = len(self.type_index) + 1
        self.type_index[name] = idx
        return 0x80000000 | idx, name


def _poly_value(ids, name, data):
    pid, pname = ids.poly(name)
    value = {"polymorphic_id": pid}
    if pname is not None:
        value["polymorphic_name"] = pname
    value["ptr_wrapper"] = {"id": ids.ptr(), "data": data}
    return value


def has_prior(scene: Scene, v) -> bool:
    """Whether view v carries a GPS pose-centre prior (a ViewPriors node)."""
    return (scene.prior_center is not None and scene.prior_center_weight is not None
            and bool(np.any(scene.prior_center_weight[v] > 0)))


def _doc_from_scene(scene: Scene, parts: int = ALL):
    ids = _PtrIds()
    doc = {"sfm_data_version": "0.3", "root_path": scene.root_path,
           "views": [], "intrinsics": [], "extrinsics": [], "structure": [],
           "control_points": []}
    if parts & VIEWS:
        for v in range(scene.n_views):
            fname = (scene.view_filename[v] if v < len(scene.view_filename)
                     else f"view_{v}")
            data = {
                "local_path": "",
                "filename": fname,
                "width": int(scene.view_wh[v, 0]),
                "height": int(scene.view_wh[v, 1]),
                "id_view": int(v),
                "id_intrinsic": int(scene.view_intrinsic[v]),
                "id_pose": int(scene.view_pose[v]),
            }
            if has_prior(scene, v):
                data["use_pose_center_prior"] = True
                data["center_weight"] = [
                    float(x) for x in scene.prior_center_weight[v]]
                data["center"] = [float(x) for x in scene.prior_center[v]]
                value = _poly_value(ids, "view_priors", data)
            else:
                value = {"polymorphic_id": 1073741824,
                         "ptr_wrapper": {"id": ids.ptr(), "data": data}}
            doc["views"].append({"key": int(v), "value": value})
    if parts & INTRINSICS:
        cams = scene.cameras
        for i in range(scene.n_intrinsics):
            kind = int(cams.kind[i])
            data = {"width": int(cams.width[i]), "height": int(cams.height[i])}
            if kind != cm.SPHERICAL:
                data["focal_length"] = float(cams.params[i, 0])
                data["principal_point"] = [float(cams.params[i, 1]),
                                           float(cams.params[i, 2])]
            if kind in _DISTO_KEY:
                key, n = _DISTO_KEY[kind]
                data[key] = [float(x) for x in cams.params[i, 3:3 + n]]
            doc["intrinsics"].append(
                {"key": int(i),
                 "value": _poly_value(ids, cm.KIND_NAMES[kind], data)})
    if parts & EXTRINSICS:
        for p in range(scene.n_poses):
            if not scene.pose_valid[p]:
                continue
            doc["extrinsics"].append({
                "key": int(p),
                "value": {
                    "rotation": [[float(x) for x in row]
                                 for row in scene.pose_R[p]],
                    "center": [float(x) for x in scene.pose_C[p]],
                },
            })
    if parts & STRUCTURE:
        doc["structure"] = _landmarks_json(
            scene.X, scene.X_valid, scene.obs_landmark, scene.obs_view,
            scene.obs_x, scene.obs_feat, scene.obs_valid)
    if parts & CONTROL_POINTS and len(scene.cp_X):
        doc["control_points"] = _landmarks_json(
            scene.cp_X, np.ones(len(scene.cp_X), bool), scene.cp_obs_landmark,
            scene.cp_obs_view, scene.cp_obs_x, scene.cp_obs_feat,
            np.ones(len(scene.cp_obs_landmark), bool))
    return doc


def _landmarks_json(X, X_valid, ol, ov, ox, of, o_valid):
    obs_by_l = {}
    for idx in np.argsort(ol, kind="stable"):
        if o_valid[idx]:
            obs_by_l.setdefault(int(ol[idx]), []).append(idx)
    out = []
    for l in range(len(X)):
        if not X_valid[l]:
            continue
        obs = [{"key": int(ov[i]),
                "value": {"id_feat": int(of[i]),
                          "x": [float(ox[i, 0]), float(ox[i, 1])]}}
               for i in obs_by_l.get(l, [])]
        out.append({"key": int(l),
                    "value": {"X": [float(x) for x in X[l]],
                              "observations": obs}})
    return out


def _undef(v):
    # openMVG UndefinedIndexT = 4294967295
    return np.int32(-1) if int(v) >= 2**31 else np.int32(v)


def _landmarks_arrays(entries):
    keys = [int(e["key"]) for e in entries]
    n = (max(keys) + 1) if keys else 0
    X = np.zeros((n, 3))
    ol, ov, ox, of = [], [], [], []
    for e in entries:
        k = int(e["key"])
        X[k] = e["value"]["X"]
        for o in e["value"]["observations"]:
            ol.append(k)
            ov.append(int(o["key"]))
            ox.append(o["value"]["x"])
            of.append(int(o["value"]["id_feat"]))
    return (X, np.asarray(ol, np.int32), np.asarray(ov, np.int32),
            np.asarray(ox, float).reshape(-1, 2), np.asarray(of, np.int32))


def _scene_from_doc(doc, parts: int = ALL) -> Scene:
    scene = Scene(root_path=doc.get("root_path", ""))

    if parts & VIEWS and doc.get("views"):
        entries = {int(e["key"]): e["value"] for e in doc["views"]}
        n = max(entries) + 1
        scene.view_filename = [""] * n
        scene.view_intrinsic = np.full(n, -1, np.int32)
        scene.view_pose = np.full(n, -1, np.int32)
        scene.view_wh = np.zeros((n, 2), np.int32)
        prior_c = np.zeros((n, 3))
        prior_w = np.zeros((n, 3))
        has_prior = False
        for k, val in entries.items():
            d = val["ptr_wrapper"]["data"]
            scene.view_filename[k] = os.path.join(
                d.get("local_path", ""), d["filename"]).lstrip("/") \
                if d.get("local_path") else d["filename"]
            scene.view_wh[k] = [d["width"], d["height"]]
            scene.view_intrinsic[k] = _undef(d["id_intrinsic"])
            scene.view_pose[k] = _undef(d["id_pose"])
            if d.get("use_pose_center_prior") or d.get("use_pose_center"):
                has_prior = True
                prior_c[k] = d.get("center", [0, 0, 0])
                prior_w[k] = d.get("center_weight", [1, 1, 1])
        if has_prior:
            scene.prior_center = prior_c
            scene.prior_center_weight = prior_w

    if parts & INTRINSICS and doc.get("intrinsics"):
        entries = {int(e["key"]): e["value"] for e in doc["intrinsics"]}
        n = max(entries) + 1
        kind = np.zeros(n, np.int32)
        width = np.zeros(n)
        height = np.zeros(n)
        params = np.zeros((n, cm.MAX_PARAMS))
        name_by_poly = {}
        for k in sorted(entries):
            val = entries[k]
            pid = val.get("polymorphic_id", 0)
            if "polymorphic_name" in val:
                name = val["polymorphic_name"]
                name_by_poly[pid & 0x7FFFFFFF] = name
            else:
                name = name_by_poly.get(pid, "pinhole")
            d = val["ptr_wrapper"]["data"]
            kd = cm.KIND_FROM_NAME.get(name, cm.PINHOLE)
            kind[k] = kd
            width[k] = d["width"]
            height[k] = d["height"]
            if kd != cm.SPHERICAL:
                params[k, 0] = d.get("focal_length", 1.0)
                params[k, 1:3] = d.get("principal_point",
                                       [d["width"] / 2, d["height"] / 2])
            if kd in _DISTO_KEY:
                key, nn = _DISTO_KEY[kd]
                params[k, 3:3 + nn] = d.get(key, [0.0] * nn)
        scene.cameras = cm.Cameras(kind=kind, width=width, height=height,
                                   params=params)

    # the pose table covers every view's pose id, estimated or not
    entries = ({int(e["key"]): e["value"] for e in doc.get("extrinsics", [])}
               if parts & EXTRINSICS else {})
    n = (max(entries) + 1) if entries else 0
    if scene.n_views and len(scene.view_pose):
        n = max(n, int(scene.view_pose.max()) + 1)
    scene.pose_valid = np.zeros(n, bool)
    scene.pose_R = np.tile(np.eye(3), (n, 1, 1))
    scene.pose_C = np.zeros((n, 3))
    for k, val in entries.items():
        scene.pose_valid[k] = True
        scene.pose_R[k] = np.asarray(val["rotation"], float)
        scene.pose_C[k] = np.asarray(val["center"], float)

    if parts & STRUCTURE and doc.get("structure"):
        keys = [int(e["key"]) for e in doc["structure"]]
        X, ol, ov, ox, of = _landmarks_arrays(doc["structure"])
        scene.X = X
        scene.X_valid = np.zeros(len(X), bool)
        if keys:
            scene.X_valid[np.asarray(keys)] = True
        scene.obs_landmark, scene.obs_view = ol, ov
        scene.obs_x, scene.obs_feat = ox, of
        scene.obs_valid = np.ones(len(ol), bool)

    if parts & CONTROL_POINTS and doc.get("control_points"):
        X, ol, ov, ox, of = _landmarks_arrays(doc["control_points"])
        scene.cp_X, scene.cp_obs_landmark, scene.cp_obs_view = X, ol, ov
        scene.cp_obs_x, scene.cp_obs_feat = ox, of
    return scene


def _ext(path):
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".json", ".bin", ".xml"):
        raise ValueError(f"unsupported sfm_data extension: {ext}")
    return ext


def load_sfm_data(path: str, parts: int = ALL) -> Scene:
    """Read a scene from .json, .bin or .xml (sfm_data_io.cpp Load)."""
    ext = _ext(path)
    if ext == ".bin":
        from openmvg_torch.io.sfm_data_bin import load_sfm_data_bin

        return load_sfm_data_bin(path, parts)
    if ext == ".xml":
        from openmvg_torch.io.sfm_data_xml import load_sfm_data_xml

        return load_sfm_data_xml(path, parts)
    with open(path) as f:
        return _scene_from_doc(json.load(f), parts)


def save_sfm_data(scene: Scene, path: str, parts: int = ALL):
    """Write a scene as .json, .bin or .xml, chosen by the extension."""
    ext = _ext(path)
    if ext == ".bin":
        from openmvg_torch.io.sfm_data_bin import save_sfm_data_bin

        return save_sfm_data_bin(scene, path, parts)
    if ext == ".xml":
        from openmvg_torch.io.sfm_data_xml import save_sfm_data_xml

        return save_sfm_data_xml(scene, path, parts)
    with open(path, "w") as f:
        json.dump(_doc_from_scene(scene, parts), f, indent=2)
    return True
