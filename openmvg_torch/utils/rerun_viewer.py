"""rerun.io scene viewer (counterpart: openmvg_tpu/utils/rerun_viewer.py;
software/SfM/python/sfm_viewer/rerun_viewer.py): log a reconstruction (cameras as pinhole frusta + images,
landmarks as a point cloud) to a rerun recording.

The rerun SDK is optional (not bundled); `log_scene` takes the module as a
parameter so the logging logic is testable without it, and the CLI entry
errors cleanly when the SDK is missing.
"""

import os

import numpy as np


def _quat_xyzw_from_R(R):
    """Rotation matrix -> quaternion (x, y, z, w) — rerun's convention."""
    from openmvg_torch.io.exporters import _quat_from_R

    w, x, y, z = _quat_from_R(R)
    return np.array([x, y, z, w])


def log_scene(scene, rr, colors=None, log_images=True):
    """Log views/poses/structure to rerun (module passed as `rr`).

    Mirrors the reference script's entity layout: `world/points` for the
    cloud, `world/camera/<filename>` per posed view with Transform3D +
    Pinhole (+ the image file when present on disk).
    """
    rr.log("world", rr.ViewCoordinates.RDF, static=True)

    X = np.asarray(scene.X[scene.X_valid], np.float32)
    if colors is not None:
        colors = np.asarray(colors, np.uint8)
        if len(colors) == scene.n_landmarks:
            colors = colors[np.asarray(scene.X_valid)]
        rr.log("world/points", rr.Points3D(X, colors=colors))
    else:
        rr.log("world/points", rr.Points3D(X))

    n_logged = 1
    for v in range(scene.n_views):
        pid = scene.view_pose[v]
        if pid < 0 or not scene.pose_valid[pid]:
            continue
        iid = int(scene.view_intrinsic[v])
        from openmvg_torch.io.exporters import _K_of

        K = _K_of(scene, iid)
        R = scene.pose_R[pid]
        C = scene.pose_C[pid]
        name = str(scene.view_filename[v])
        ent = f"world/camera/{name}"
        # camera-to-world: rotation R^T, translation C
        rr.log(ent, rr.Transform3D(
            translation=np.asarray(C, np.float32),
            rotation=rr.Quaternion(xyzw=_quat_xyzw_from_R(R.T))))
        rr.log(ent + "/image", rr.Pinhole(
            image_from_camera=np.asarray(K, np.float32),
            width=int(scene.cameras.width[iid]),
            height=int(scene.cameras.height[iid])))
        img_path = os.path.join(scene.root_path or "", name)
        if log_images and os.path.exists(img_path):
            rr.log(ent + "/image", rr.EncodedImage(path=img_path))
        n_logged += 2
    return n_logged


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="view a reconstruction in rerun (pip install rerun-sdk)")
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("--no-images", action="store_true")
    args = p.parse_args(argv)
    try:
        import rerun as rr
    except ImportError:
        raise SystemExit(
            "rerun-sdk is not installed; install it with "
            "`pip install rerun-sdk` to use the viewer "
            "(all other commands work without it)")
    from openmvg_torch.io.sfm_data import load_sfm_data

    scene = load_sfm_data(args.input_file)
    rr.init("openmvg_torch", spawn=True)
    log_scene(scene, rr, log_images=not args.no_images)


if __name__ == "__main__":
    main()
