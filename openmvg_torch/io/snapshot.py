"""Scene snapshots for checkpoint and resume (counterpart:
openmvg_tpu/io/snapshot.py): a Scene as one compressed .npz (poses,
structure, observation table, camera parameters, and the paths as JSON
metadata), in the reference's layout, so a snapshot written by either
package loads in the other.  The engines write one after each round when
asked (IncrementalConfig.dump_dir); sfm_data .json/.bin stay the
exchange formats.
"""

import json

import numpy as np

from openmvg_torch.models import cameras as cm
from openmvg_torch.sfm.scene import Scene

_ARRAYS = [
    "view_intrinsic", "view_pose", "view_wh", "pose_valid", "pose_R",
    "pose_C", "X", "X_valid", "obs_landmark", "obs_view", "obs_x",
    "obs_feat", "obs_valid", "cp_X", "cp_obs_landmark", "cp_obs_view",
    "cp_obs_x", "cp_obs_feat",
]


def save_snapshot(scene: Scene, path: str):
    meta = dict(root_path=scene.root_path, view_filename=list(scene.view_filename),
                has_priors=scene.prior_center is not None)
    payload = {k: np.asarray(getattr(scene, k)) for k in _ARRAYS}
    payload["cam_kind"] = np.asarray(scene.cameras.kind)
    payload["cam_width"] = np.asarray(scene.cameras.width)
    payload["cam_height"] = np.asarray(scene.cameras.height)
    payload["cam_params"] = np.asarray(scene.cameras.params)
    if scene.prior_center is not None:
        payload["prior_center"] = scene.prior_center
        payload["prior_center_weight"] = scene.prior_center_weight
    payload["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **payload)
    return True


def load_snapshot(path: str) -> Scene:
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        scene = Scene(root_path=meta["root_path"])
        scene.view_filename = list(meta["view_filename"])
        for k in _ARRAYS:
            setattr(scene, k, z[k].copy())
        scene.cameras = cm.Cameras(kind=z["cam_kind"].copy(), width=z["cam_width"].copy(),
                                   height=z["cam_height"].copy(),
                                   params=z["cam_params"].copy())
        if meta.get("has_priors"):
            scene.prior_center = z["prior_center"].copy()
            scene.prior_center_weight = z["prior_center_weight"].copy()
    return scene
