"""PLY export of structure and camera centres (counterpart:
openmvg_tpu/io/ply.py; openMVG sfm/sfm_data_io_ply.hpp Save_PLY): ASCII
points with colours, camera centres in green."""

import numpy as np


def save_ply(path, points, colors=None, camera_centers=None):
    points = np.asarray(points, np.float64).reshape(-1, 3)
    n_cam = 0 if camera_centers is None else len(camera_centers)
    if colors is None:
        colors = np.full((len(points), 3), 255, np.uint8)
    colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points) + n_cam}\n")
        f.write("property double x\nproperty double y\nproperty double z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(points, colors):
            f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
        if camera_centers is not None:
            for p in np.asarray(camera_centers).reshape(-1, 3):
                f.write(f"{p[0]} {p[1]} {p[2]} 0 255 0\n")
    return True


def save_scene_ply(scene, path):
    """Save_PLY(sfm_data): valid landmarks and valid pose centres."""
    return save_ply(path, scene.X[scene.X_valid],
                    camera_centers=scene.pose_C[scene.pose_valid])


def load_ply_vertices(path):
    """(N, 3) positions and (N, 3) uint8 colours of an ASCII PLY written by
    save_ply (camera centres included, last)."""
    with open(path) as f:
        n = 0
        for line in f:
            if line.startswith("element vertex"):
                n = int(line.split()[2])
            if line.strip() == "end_header":
                break
        rows = np.loadtxt(f, ndmin=2, max_rows=n) if n else np.zeros((0, 6))
    return rows[:, :3], rows[:, 3:6].astype(np.uint8)
