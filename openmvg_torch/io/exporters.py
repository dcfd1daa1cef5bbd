"""Scene exporters to third-party formats (counterpart, host numpy as
there: openmvg_tpu/io/exporters.py; the same bytes for the same scene).

Reference parity: software/SfM/export/ — main_openMVG2NVM.cpp (VisualSFM
NVM_V3), main_openMVG2Colmap.cpp (cameras.txt / images.txt /
points3D.txt), BAF, Bundler, PMVS, MVE, openMVS, Agisoft, MeshLab,
MVS-Texturing, CMPMVS, camera frustums and a WebGL viewer, all one Scene
traversal each; export_undistorted_images resamples on the device
(ops/image_ops.undistort_image) and writes PNG through the port's own
writer.
"""

import os

import numpy as np


def _quat_from_R(R):
    """Rotation matrix -> quaternion (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _posed_views(scene):
    return scene.valid_view_poses().tolist()


def export_nvm(scene, path, colors=None):
    """VisualSFM NVM_V3 (export/main_openMVG2NVM.cpp)."""
    posed = _posed_views(scene)
    view_slot = {v: i for i, v in enumerate(posed)}
    with open(path, "w") as f:
        f.write("NVM_V3\n\n")
        f.write(f"{len(posed)}\n")
        for v in posed:
            pid = scene.view_pose[v]
            iid = scene.view_intrinsic[v]
            focal = float(np.asarray(scene.cameras.params)[iid, 0])
            q = _quat_from_R(scene.pose_R[pid])
            C = scene.pose_C[pid]
            name = scene.view_filename[v]
            f.write(f"{name} {focal} {q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{C[0]} {C[1]} {C[2]} 0 0\n")
        # measurements per landmark
        ok = scene.obs_valid & scene.X_valid[scene.obs_landmark]
        by_lm = {}
        for idx in np.nonzero(ok)[0]:
            v = int(scene.obs_view[idx])
            if v in view_slot:
                by_lm.setdefault(int(scene.obs_landmark[idx]), []).append(idx)
        lms = [l for l in np.nonzero(scene.X_valid)[0] if by_lm.get(int(l))]
        f.write(f"{len(lms)}\n")
        if colors is None:
            colors = np.full((len(scene.X), 3), 255, int)
        for l in lms:
            X = scene.X[l]
            c = colors[l]
            obs = by_lm[int(l)]
            parts = [f"{X[0]} {X[1]} {X[2]} {int(c[0])} {int(c[1])} {int(c[2])} "
                     f"{len(obs)}"]
            for idx in obs:
                v = int(scene.obs_view[idx])
                iid = scene.view_intrinsic[v]
                pp = np.asarray(scene.cameras.params)[iid, 1:3]
                x = scene.obs_x[idx] - pp  # NVM stores pp-centered coords
                parts.append(f"{view_slot[v]} {int(scene.obs_feat[idx])} "
                             f"{x[0]} {x[1]}")
            f.write(" ".join(parts) + "\n")
        f.write("0\n")
    return True


def export_colmap(scene, outdir, colors=None):
    """COLMAP text model (export/main_openMVG2Colmap.cpp)."""
    os.makedirs(outdir, exist_ok=True)
    cams = scene.cameras
    with open(os.path.join(outdir, "cameras.txt"), "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        for i in range(scene.n_intrinsics):
            p = np.asarray(cams.params)[i]
            w = int(cams.width[i])
            h = int(cams.height[i])
            kind = int(np.asarray(cams.kind)[i])
            if kind == 3:  # radial k3 -> FULL_OPENCV would be closer; use RADIAL
                f.write(f"{i + 1} RADIAL {w} {h} {p[0]} {p[1]} {p[2]} "
                        f"{p[3]} {p[4]}\n")
            else:
                f.write(f"{i + 1} SIMPLE_PINHOLE {w} {h} {p[0]} {p[1]} {p[2]}\n")

    ok = scene.obs_valid & scene.X_valid[scene.obs_landmark]
    obs_by_view = {}
    obs_by_lm = {}
    for idx in np.nonzero(ok)[0]:
        obs_by_view.setdefault(int(scene.obs_view[idx]), []).append(idx)
        obs_by_lm.setdefault(int(scene.obs_landmark[idx]), []).append(idx)

    with open(os.path.join(outdir, "images.txt"), "w") as f:
        f.write("# IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME / POINTS2D\n")
        for v in range(scene.n_views):
            pid = scene.view_pose[v]
            if pid < 0 or not scene.pose_valid[pid]:
                continue
            R = scene.pose_R[pid]
            t = -R @ scene.pose_C[pid]
            q = _quat_from_R(R)
            f.write(f"{v + 1} {q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{t[0]} {t[1]} {t[2]} {int(scene.view_intrinsic[v]) + 1} "
                    f"{scene.view_filename[v]}\n")
            pts = []
            for idx in obs_by_view.get(v, []):
                x = scene.obs_x[idx]
                pts.append(f"{x[0]} {x[1]} {int(scene.obs_landmark[idx]) + 1}")
            f.write(" ".join(pts) + "\n")

    if colors is None:
        colors = np.full((len(scene.X), 3), 255, int)
    with open(os.path.join(outdir, "points3D.txt"), "w") as f:
        f.write("# POINT3D_ID X Y Z R G B ERROR TRACK[]\n")
        for l in np.nonzero(scene.X_valid)[0]:
            X = scene.X[l]
            c = colors[l]
            track = []
            for idx in obs_by_lm.get(int(l), []):
                track.append(f"{int(scene.obs_view[idx]) + 1} "
                             f"{int(scene.obs_feat[idx])}")
            f.write(f"{l + 1} {X[0]} {X[1]} {X[2]} {int(c[0])} {int(c[1])} "
                    f"{int(c[2])} 0 " + " ".join(track) + "\n")
    return True


def export_baf(scene, path):
    """ASCII Bundle Adjustment File (sfm_data_io_baf.hpp Save_BAF):
    header = #intrinsics #views #landmarks; intrinsic param rows; per-view
    pose rows [R col-major, C] (identity for missing poses); landmark rows
    [X #obs (id_intrinsic id_pose x y)*]; plus <path>_imgList.txt."""
    from openmvg_torch.models import cameras as cm

    cams = scene.cameras
    ok = scene.obs_valid & scene.X_valid[scene.obs_landmark]
    obs_by_lm = {}
    for idx in np.nonzero(ok)[0]:
        obs_by_lm.setdefault(int(scene.obs_landmark[idx]), []).append(idx)
    lms = [l for l in np.nonzero(scene.X_valid)[0]]
    with open(path, "w") as f:
        f.write(f"{scene.n_intrinsics}\n{scene.n_views}\n{len(lms)}\n")
        for i in range(scene.n_intrinsics):
            kind = int(np.asarray(cams.kind)[i])
            n = cm.N_PARAMS[kind]
            f.write(" ".join(str(float(v))
                             for v in np.asarray(cams.params)[i, :n]) + " \n")
        for v in range(scene.n_views):
            pid = scene.view_pose[v]
            if pid < 0 or not scene.pose_valid[pid]:
                R = np.eye(3)
                C = np.zeros(3)
            else:
                R = scene.pose_R[pid]
                C = scene.pose_C[pid]
            vals = list(R.T.reshape(-1)) + list(C)  # column major
            f.write(" ".join(str(float(x)) for x in vals) + " \n")
        for l in lms:
            X = scene.X[l]
            obs = obs_by_lm.get(int(l), [])
            parts = [f"{X[0]} {X[1]} {X[2]}", str(len(obs))]
            for idx in obs:
                v = int(scene.obs_view[idx])
                parts.append(f"{int(scene.view_intrinsic[v])} "
                             f"{int(scene.view_pose[v])} "
                             f"{scene.obs_x[idx, 0]} {scene.obs_x[idx, 1]}")
            f.write(" ".join(parts) + "\n")
    with open(path + "_imgList.txt", "w") as f:
        for v in range(scene.n_views):
            f.write(f"{scene.view_filename[v]} {int(scene.view_intrinsic[v])} "
                    f"{int(scene.view_pose[v])}\n")
    return True


def export_bundler(scene, path, colors=None):
    """Bundler .out format (export/main_openMVG2Bundler-style): header,
    per-camera [f k1 k2 / R / t] (Bundler's -z convention), points."""
    posed = _posed_views(scene)
    slot = {v: i for i, v in enumerate(posed)}
    ok = scene.obs_valid & scene.X_valid[scene.obs_landmark]
    obs_by_lm = {}
    for idx in np.nonzero(ok)[0]:
        if int(scene.obs_view[idx]) in slot:
            obs_by_lm.setdefault(int(scene.obs_landmark[idx]), []).append(idx)
    lms = [l for l in np.nonzero(scene.X_valid)[0] if obs_by_lm.get(int(l))]
    D = np.diag([1.0, -1.0, -1.0])  # openMVG cam -> bundler cam
    if colors is None:
        colors = np.full((len(scene.X), 3), 255, int)
    with open(path, "w") as f:
        f.write("# Bundle file v0.3\n")
        f.write(f"{len(posed)} {len(lms)}\n")
        for v in posed:
            pid = scene.view_pose[v]
            iid = scene.view_intrinsic[v]
            focal = float(np.asarray(scene.cameras.params)[iid, 0])
            R = D @ scene.pose_R[pid]
            t = R @ (-scene.pose_C[pid])
            f.write(f"{focal} 0 0\n")
            for row in R:
                f.write(f"{row[0]} {row[1]} {row[2]}\n")
            f.write(f"{t[0]} {t[1]} {t[2]}\n")
        for l in lms:
            X = scene.X[l]
            c = colors[l]
            f.write(f"{X[0]} {X[1]} {X[2]}\n")
            f.write(f"{int(c[0])} {int(c[1])} {int(c[2])}\n")
            obs = obs_by_lm[int(l)]
            parts = [str(len(obs))]
            for idx in obs:
                v = int(scene.obs_view[idx])
                iid = scene.view_intrinsic[v]
                pp = np.asarray(scene.cameras.params)[iid, 1:3]
                x = scene.obs_x[idx] - pp
                parts.append(f"{slot[v]} {int(scene.obs_feat[idx])} "
                             f"{x[0]} {-x[1]}")
            f.write(" ".join(parts) + "\n")
    return True


def export_pmvs(scene, outdir, image_provider=None):
    """PMVS working directory (export/main_openMVG2PMVS.cpp):
    txt/%08d.txt projection matrices, visualize/ images (if provider),
    pmvs_options.txt."""
    from openmvg_torch.models.cameras import K_matrix_np

    os.makedirs(os.path.join(outdir, "txt"), exist_ok=True)
    os.makedirs(os.path.join(outdir, "visualize"), exist_ok=True)
    os.makedirs(os.path.join(outdir, "models"), exist_ok=True)
    posed = _posed_views(scene)
    for i, v in enumerate(posed):
        pid = scene.view_pose[v]
        iid = scene.view_intrinsic[v]
        K = K_matrix_np(np.asarray(scene.cameras.params)[iid])
        R = scene.pose_R[pid]
        t = -R @ scene.pose_C[pid]
        P = K @ np.concatenate([R, t[:, None]], axis=1)
        with open(os.path.join(outdir, "txt", f"{i:08d}.txt"), "w") as f:
            f.write("CONTOUR\n")
            for row in P:
                f.write(f"{row[0]} {row[1]} {row[2]} {row[3]}\n")
    with open(os.path.join(outdir, "pmvs_options.txt"), "w") as f:
        f.write("level 1\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
                f"CPU 8\nsetEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
                f"timages -1 0 {len(posed)}\noimages 0\n")
    return True


def export_mve(scene, outdir):
    """MVE scene directory (export/main_openMVG2MVE2.cpp): views/*.mve
    folders with meta.ini camera parameters."""
    views_dir = os.path.join(outdir, "views")
    os.makedirs(views_dir, exist_ok=True)
    posed = _posed_views(scene)
    for i, v in enumerate(posed):
        d = os.path.join(views_dir, f"view_{i:04d}.mve")
        os.makedirs(d, exist_ok=True)
        pid = scene.view_pose[v]
        iid = scene.view_intrinsic[v]
        p = np.asarray(scene.cameras.params)[iid]
        w = float(scene.cameras.width[iid])
        h = float(scene.cameras.height[iid])
        R = scene.pose_R[pid]
        t = -R @ scene.pose_C[pid]
        flen = p[0] / max(w, h)  # MVE normalized focal
        with open(os.path.join(d, "meta.ini"), "w") as f:
            f.write("[camera]\n")
            f.write(f"focal_length = {flen}\n")
            f.write("pixel_aspect = 1\n")
            f.write(f"principal_point = {p[1] / w} {p[2] / h}\n")
            f.write("rotation = " + " ".join(str(x) for x in R.reshape(-1)) + "\n")
            f.write("translation = " + " ".join(str(x) for x in t) + "\n")
            f.write("[view]\n")
            f.write(f"id = {i}\nname = {scene.view_filename[v]}\n")
    return True


# ---------------------------------------------------------------------------
# openMVS interface (.mvs), Agisoft, Meshlab, MVSTexturing, CMPMVS, frustums
# ---------------------------------------------------------------------------

def _K_of(scene, iid):
    p = np.asarray(scene.cameras.params)[iid]
    return np.array([[p[0], 0.0, p[1]], [0.0, p[0], p[2]], [0.0, 0.0, 1.0]])


def export_openmvs(scene, path, images_dir="undistorted_images", colors=None):
    """OpenMVS MVSI binary scene (export/main_openMVG2openMVS.cpp:60-302,
    serialization layout per export/InterfaceMVS.h:370-733, stream version 6).

    One platform per pinhole intrinsic with an identity camera sub-pose; one
    platform pose per posed view; landmarks become vertices with >=2 views.
    Image `name` fields point into `images_dir` (written by
    `export_undistorted_images`).
    """
    import struct

    buf = bytearray()

    def w_u32(v):
        buf.extend(struct.pack("<I", int(v)))

    def w_u64(v):
        buf.extend(struct.pack("<Q", int(v)))

    def w_str(s):
        b = s.encode()
        w_u64(len(b))
        buf.extend(b)

    def w_d(*vals):
        buf.extend(struct.pack("<%dd" % len(vals), *[float(v) for v in vals]))

    def w_f(*vals):
        buf.extend(struct.pack("<%df" % len(vals), *[float(v) for v in vals]))

    buf.extend(b"MVSI")
    w_u32(6)   # MVSI_PROJECT_VER
    w_u32(0)   # reserved

    posed = _posed_views(scene)
    # platforms: one per intrinsic used by a posed view (contiguous remap)
    used_intr = sorted({int(scene.view_intrinsic[v]) for v in posed})
    plat_of_intr = {iid: i for i, iid in enumerate(used_intr)}
    plat_poses = {iid: [] for iid in used_intr}   # list of (R, C)
    images = []                                   # (name, platformID, poseID, ID)
    view_slot = {}
    for v in posed:
        iid = int(scene.view_intrinsic[v])
        pid = int(scene.view_pose[v])
        pose_id = len(plat_poses[iid])
        plat_poses[iid].append((scene.pose_R[pid], scene.pose_C[pid]))
        view_slot[v] = len(images)
        name = os.path.join(images_dir, os.path.basename(scene.view_filename[v]))
        images.append((name, plat_of_intr[iid], pose_id, view_slot[v]))

    w_u64(len(used_intr))                 # platforms
    for iid in used_intr:
        w_str(f"platform_{iid}")          # Platform.name
        w_u64(1)                          # one camera
        w_str("")                         # Camera.name
        w_str("")                         # Camera.bandName (ver>3)
        w_u32(int(scene.cameras.width[iid]))
        w_u32(int(scene.cameras.height[iid]))
        w_d(*_K_of(scene, iid).reshape(-1))      # K row-major
        w_d(*np.eye(3).reshape(-1))              # R sub-pose
        w_d(0, 0, 0)                             # C sub-pose
        w_u64(len(plat_poses[iid]))
        for R, C in plat_poses[iid]:
            w_d(*np.asarray(R).reshape(-1))
            w_d(*np.asarray(C).reshape(-1))

    w_u64(len(images))                    # images
    for name, plat, pose_id, gid in images:
        w_str(name)
        w_str("")                         # maskName (ver>4)
        w_u32(plat)                       # platformID
        w_u32(0)                          # cameraID
        w_u32(pose_id)                    # poseID
        w_u32(gid)                        # ID (ver>2)

    # vertices: landmarks with >=2 posed observations
    ok = scene.obs_valid & scene.X_valid[scene.obs_landmark]
    by_lm = {}
    for idx in np.nonzero(ok)[0]:
        v = int(scene.obs_view[idx])
        if v in view_slot:
            by_lm.setdefault(int(scene.obs_landmark[idx]), []).append(view_slot[v])
    verts = [(l, sorted(set(vs))) for l, vs in sorted(by_lm.items())
             if len(set(vs)) >= 2]
    w_u64(len(verts))
    for l, vs in verts:
        w_f(*scene.X[l])
        w_u64(len(vs))
        for s in vs:
            w_u32(s)
            w_f(0.0)                      # confidence
    w_u64(0)                              # verticesNormal
    if colors is not None:
        w_u64(len(verts))
        for l, _ in verts:
            c = np.asarray(colors[l], np.uint8)
            buf.extend(bytes([int(c[2]), int(c[1]), int(c[0])]))  # BGR Col3
    else:
        w_u64(0)                          # verticesColor
    w_u64(0)                              # lines (ver>0)
    w_u64(0)                              # linesNormal
    w_u64(0)                              # linesColor
    w_d(*np.eye(4).reshape(-1))           # transform (ver>1)
    w_d(*np.eye(3).reshape(-1))           # obb.rot (ver>5)
    w_d(0, 0, 0)                          # obb.ptMin
    w_d(0, 0, 0)                          # obb.ptMax
    with open(path, "wb") as f:
        f.write(bytes(buf))
    return True


def export_agisoft(scene, outdir):
    """Agisoft PhotoScan/Metashape cameras.xml
    (export/main_openMVG2Agisoft.cpp:75-180)."""
    os.makedirs(outdir, exist_ok=True)
    lines = ['<?xml version="1.0" encoding="UTF-8"?>',
             '<document version="1.3.0">', "<chunk>", "<sensors>"]
    prm = np.asarray(scene.cameras.params)
    kinds = np.asarray(scene.cameras.kind)
    for i in range(scene.n_intrinsics):
        w, h = int(scene.cameras.width[i]), int(scene.cameras.height[i])
        p = prm[i]
        lines += [
            f'<sensor id="{i}" label="sensor_{i}" type="frame">',
            f'<resolution width="{w}" height="{h}"/>',
            '<property name="fixed" value="false"/>',
            '<calibration type="frame" class="adjusted">',
            f'<resolution width="{w}" height="{h}"/>',
            f"<fx>{p[0]!r}</fx>", f"<fy>{p[0]!r}</fy>",
            f"<cx>{p[1]!r}</cx>", f"<cy>{p[2]!r}</cy>"]
        k = int(kinds[i])
        if k == 2:      # radial k1
            lines.append(f"<k1>{p[3]!r}</k1>")
        elif k == 3:    # radial k3
            lines += [f"<k1>{p[3]!r}</k1>", f"<k2>{p[4]!r}</k2>",
                      f"<k3>{p[5]!r}</k3>"]
        elif k == 4:    # brown t2: k1 k2 p1 p2 then k3 (reference order)
            lines += [f"<k1>{p[3]!r}</k1>", f"<k2>{p[4]!r}</k2>",
                      f"<p1>{p[6]!r}</p1>", f"<p2>{p[7]!r}</p2>",
                      f"<k3>{p[5]!r}</k3>"]
        lines += ["</calibration>", "</sensor>"]
    lines.append("</sensors>")
    lines.append("<cameras>")
    for v in _posed_views(scene):
        pid = scene.view_pose[v]
        R, C = scene.pose_R[pid], scene.pose_C[pid]
        # pose.inverse().asMatrix() = [R^T | C] (cam->world)
        M = np.concatenate([R.T, C[:, None]], axis=1)
        label = os.path.splitext(os.path.basename(scene.view_filename[v]))[0]
        flat = " ".join(str(x) for x in M.reshape(-1))
        lines += [f'<camera id="{v}" label="{label}" '
                  f'sensor_id="{int(scene.view_intrinsic[v])}" enabled="1">',
                  f"<transform>{flat} 0.0 0.0 0.0 1.0</transform>",
                  "</camera>"]
    lines += ["</cameras>",
              "<region>", "<center>0 0 0 </center>", "<size>100 100 100 </size>",
              "<R>1 0 0 0 1 0 0 0 1 </R>", "</region>",
              "<settings>",
              '<property name="accuracy_tiepoints" value="1"/>',
              '<property name="accuracy_cameras" value="10" />',
              '<property name="accuracy_cameras_ypr" value="2" />',
              '<property name="accuracy_markers" value="0.005" />',
              '<property name="accuracy_scalebars" value="0.001" />',
              '<property name="accuracy_projections" value="0.1" />',
              "</settings>", "</chunk>", "</document>"]
    with open(os.path.join(outdir, "cameras.xml"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return True


def export_meshlab(scene, outdir, ply_path="scene.ply"):
    """MeshLab project .mlp with rasters per posed view
    (export/main_openMVG2MESHLAB.cpp:68-135)."""
    os.makedirs(outdir, exist_ok=True)
    out = ["<!DOCTYPE MeshLabDocument>", "<MeshLabProject>", " <MeshGroup>",
           f'  <MLMesh label="{ply_path}" filename="{ply_path}">',
           "   <MLMatrix44>", "1 0 0 0 ", "0 1 0 0 ", "0 0 1 0 ", "0 0 0 1 ",
           "</MLMatrix44>", "  </MLMesh>", " </MeshGroup>", " <RasterGroup>"]
    for v in _posed_views(scene):
        pid = scene.view_pose[v]
        iid = int(scene.view_intrinsic[v])
        K = _K_of(scene, iid)
        R0, C = scene.pose_R[pid], scene.pose_C[pid]
        t0 = -R0 @ C
        # reference negates P rows 1..2 then re-decomposes; equivalent to
        # flipping the y/z rows of R and t (Meshlab's camera convention)
        S = np.diag([1.0, -1.0, -1.0])
        R = S @ R0
        t = S @ t0
        optical_center = R.T @ t
        w, h = int(scene.cameras.width[iid]), int(scene.cameras.height[iid])
        name = os.path.basename(scene.view_filename[v])
        src = os.path.join(scene.root_path, scene.view_filename[v])
        rot = " ".join(
            f"{R[i, 0]} {R[i, 1]} {R[i, 2]} 0 " for i in range(3))
        out += [f'  <MLRaster label="{name}">',
                f'   <VCGCamera TranslationVector="{optical_center[0]} '
                f'{optical_center[1]} {optical_center[2]}  1 "'
                f' LensDistortion="0 0"'
                f' ViewportPx="{w} {h}"'
                f' PixelSizeMm="1 1"'
                f' CenterPx="{w / 2.0} {h / 2.0}"'
                f' FocalMm="{K[0, 0]}"'
                f' RotationMatrix="{rot}0 0 0 1 "/>',
                f'   <Plane semantic="" fileName="{src}"/> ',
                "  </MLRaster>"]
    out += ["   </RasterGroup>", "</MeshLabProject>"]
    with open(os.path.join(outdir, "sceneMeshlab.mlp"), "w") as f:
        f.write("\n".join(out) + "\n")
    return True


def export_mvstexturing(scene, outdir):
    """MVS Texturing per-view .cam files
    (export/main_openMVG2MVSTEXTURING.cpp:60-110): world->cam t and R on the
    first line, then `f/max(w,h) 0 0 1 ppx/w ppy/h`."""
    os.makedirs(outdir, exist_ok=True)
    for v in _posed_views(scene):
        pid = scene.view_pose[v]
        iid = int(scene.view_intrinsic[v])
        p = np.asarray(scene.cameras.params)[iid]
        w, h = int(scene.cameras.width[iid]), int(scene.cameras.height[iid])
        R = scene.pose_R[pid]
        t = -R @ scene.pose_C[pid]
        base = os.path.splitext(os.path.basename(scene.view_filename[v]))[0]
        with open(os.path.join(outdir, base + ".cam"), "w") as f:
            f.write(f"{t[0]} {t[1]} {t[2]} "
                    + " ".join(str(x) for x in R.reshape(-1)) + "\n")
            f.write(f"{p[0] / max(w, h)} 0 0 1 {p[1] / w} {p[2] / h}")
    return True


def export_cmpmvs(scene, outdir):
    """CMPMVS input (export/main_openMVG2CMPMVS.cpp:60-200): per-view
    `%05d_P.txt` projective matrices plus the two run .ini scripts.  Image
    conversion to jpg is done by `export_undistorted_images` separately."""
    os.makedirs(outdir, exist_ok=True)
    posed = _posed_views(scene)
    wh = None
    for i, v in enumerate(posed):
        pid = scene.view_pose[v]
        iid = int(scene.view_intrinsic[v])
        K = _K_of(scene, iid)
        R, C = scene.pose_R[pid], scene.pose_C[pid]
        P = K @ np.concatenate([R, (-R @ C)[:, None]], axis=1)
        wh = (int(scene.cameras.width[iid]), int(scene.cameras.height[iid]))
        with open(os.path.join(outdir, f"{i:05d}_P.txt"), "w") as f:
            f.write("CONTOUR\n")
            for row in P:
                f.write(f"{row[0]} {row[1]} {row[2]} {row[3]}\n")
    if wh is None:
        return False
    common = (f'[global]\ndirName="{outdir}/"\nprefix=""\nimgExt="jpg"\n'
              f"ncams={len(posed)}\nwidth={wh[0]}\nheight={wh[1]}\nscale=2\n"
              f'workDirName="_tmp_fast"\n')
    with open(os.path.join(outdir, "01_mvs_firstRun.ini"), "w") as f:
        f.write(common + "doPrepareData=TRUE\ndoPrematchSifts=TRUE\n"
                "doPlaneSweepingSGM=TRUE\ndoFuse=TRUE\nnTimesSimplify=10\n\n"
                "[prematching]\nminAngle=3.0\n\n"
                "[grow]\nminNumOfConsistentCams=6\n\n"
                "[filter]\nminNumOfConsistentCams=2\n\n")
    with open(os.path.join(outdir, "02_mvs_limitedScale.ini"), "w") as f:
        f.write(common + "doPrepareData=FALSE\ndoPrematchSifts=FALSE\n"
                "doPlaneSweepingSGM=FALSE\ndoFuse=FALSE\n\n"
                "[uvatlas]\ntexSide=1024\nscale=1\n\n"
                "[delanuaycut]\nsaveMeshTextured=FALSE\n\n"
                "[hallucinationsFiltering]\nuseSkyPrior=FALSE\n")
    return True


def export_frustums_ply(scene, path, z_near=-1.0, z_far=-1.0, colorize=False):
    """Camera frustums as a triangle-mesh PLY
    (export/main_ExportCameraFrustums.cpp + sfm_data_filters_frustum.cpp):
    per-view depth range from the structure when z_near/z_far < 0, unit
    pyramids when the scene has no structure."""
    from openmvg_torch.geometry.frustum import frustum_corners

    posed = _posed_views(scene)
    have_structure = scene.n_landmarks > 0 and scene.n_observations > 0
    verts, faces, vcols = [], [], []
    rng = np.random.default_rng(0)
    for v in posed:
        pid = scene.view_pose[v]
        iid = int(scene.view_intrinsic[v])
        K = _K_of(scene, iid)
        R, C = scene.pose_R[pid], scene.pose_C[pid]
        w, h = int(scene.cameras.width[iid]), int(scene.cameras.height[iid])
        zn, zf = z_near, z_far
        if (zn < 0 or zf < 0) and have_structure:
            sel = (scene.obs_valid & (scene.obs_view == v)
                   & scene.X_valid[scene.obs_landmark])
            if sel.any():
                Xc = (R @ (scene.X[scene.obs_landmark[sel]] - C).T).T
                depths = Xc[:, 2][Xc[:, 2] > 0]
                if len(depths):
                    zf = float(np.max(depths)) if zf < 0 else zf
                    zn = max(1e-3 * zf, float(np.min(depths))) if zn < 0 else zn
        if zn < 0 or zf < 0:
            zn, zf = 0.01, 1.0   # unit cone fallback
        far = np.asarray(frustum_corners(K, R, C, w, h, zn, zf))[4:]
        base = len(verts)
        verts.append(C)
        verts.extend(far)
        col = (rng.integers(64, 255, 3).tolist() if colorize else [255, 255, 255])
        for _ in range(5):
            vcols.append(col)
        for a, b in ((0, 1), (1, 2), (2, 3), (3, 0)):
            faces.append((base, base + 1 + a, base + 1 + b))
        faces.append((base + 1, base + 2, base + 3))
        faces.append((base + 1, base + 3, base + 4))
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property double x\nproperty double y\nproperty double z\n")
        if colorize:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {len(faces)}\n"
                "property list uchar int vertex_index\nend_header\n")
        for i, p in enumerate(verts):
            line = f"{p[0]} {p[1]} {p[2]}"
            if colorize:
                c = vcols[i]
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")
        for a, b, c in faces:
            f.write(f"3 {a} {b} {c}\n")
    return True


def export_undistorted_images(scene, outdir, image_loader=None, writer=None,
                              device="cuda"):
    """Per-view undistorted images (export/main_ExportUndistortedImages.cpp,
    and the undistortion step of main_openMVG2openMVS.cpp:138-233), named as
    the views.  A view whose camera has no distortion is copied unchanged;
    the others are resampled on `device` (every channel of an (H, W, C)
    image, as floats in [0, 1] for a uint8 image) and written by `writer`
    (io/image.write_image: PNG without PIL)."""
    import shutil

    import torch

    from openmvg_torch.models import cameras as cm
    from openmvg_torch.ops.image_ops import undistort_image

    if image_loader is None:
        from openmvg_torch.io.image import read_image as image_loader
    if writer is None:
        from openmvg_torch.io.image import write_image as writer
    os.makedirs(outdir, exist_ok=True)
    prm = np.asarray(scene.cameras.params)
    kinds = np.asarray(scene.cameras.kind)
    for v in range(scene.n_views):
        src = os.path.join(scene.root_path, scene.view_filename[v])
        dst = os.path.join(outdir, os.path.basename(scene.view_filename[v]))
        if not os.path.exists(src):
            continue
        iid = int(scene.view_intrinsic[v])
        if int(kinds[iid]) == cm.PINHOLE or not np.any(prm[iid, 3:] != 0):
            shutil.copyfile(src, dst)
            continue
        img = np.asarray(image_loader(src))
        a = torch.as_tensor(img, dtype=torch.float32, device=device)
        if img.dtype == np.uint8:
            a = a / 255.0
        chw = a.movedim(-1, 0) if a.dim() == 3 else a
        out = undistort_image(chw, int(kinds[iid]), prm[iid], float(scene.cameras.width[iid]),
                              float(scene.cameras.height[iid]))
        writer(dst, (out.movedim(0, -1) if a.dim() == 3 else out).cpu().numpy())
    return True


_WEBGL_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>openmvg_tpu scene</title><style>
html,body{margin:0;height:100%;overflow:hidden;background:#10131a;color:#cbd3e1;
font:12px system-ui,sans-serif}
#hud{position:fixed;left:10px;top:8px;user-select:none;pointer-events:none}
canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<div id="hud">__NPTS__ points &middot; __NCAMS__ cameras &mdash;
drag: orbit &middot; wheel: zoom &middot; shift-drag: pan</div>
<canvas id="c"></canvas>
<script>
"use strict";
const PTS = new Float32Array(Uint8Array.from(atob("__PTS__"),c=>c.charCodeAt(0)).buffer);
const COL = new Uint8Array(Uint8Array.from(atob("__COL__"),c=>c.charCodeAt(0)).buffer);
const CAM = new Float32Array(Uint8Array.from(atob("__CAM__"),c=>c.charCodeAt(0)).buffer);
const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl", {antialias:true});
function sh(type, src){const s=gl.createShader(type);gl.shaderSource(s,src);
gl.compileShader(s);return s;}
function prog(vs, fs){const p=gl.createProgram();
gl.attachShader(p,sh(gl.VERTEX_SHADER,vs));gl.attachShader(p,sh(gl.FRAGMENT_SHADER,fs));
gl.linkProgram(p);return p;}
const pPts = prog(
"attribute vec3 p;attribute vec3 c;uniform mat4 mvp;varying vec3 vc;"+
"void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=2.0;vc=c;}",
"precision mediump float;varying vec3 vc;void main(){gl_FragColor=vec4(vc,1.0);}");
const pLin = prog(
"attribute vec3 p;uniform mat4 mvp;void main(){gl_Position=mvp*vec4(p,1.0);}",
"precision mediump float;void main(){gl_FragColor=vec4(0.30,0.75,0.58,1.0);}");
const bufP=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,bufP);
gl.bufferData(gl.ARRAY_BUFFER,PTS,gl.STATIC_DRAW);
const bufC=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,bufC);
gl.bufferData(gl.ARRAY_BUFFER,COL,gl.STATIC_DRAW);
const bufL=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,bufL);
gl.bufferData(gl.ARRAY_BUFFER,CAM,gl.STATIC_DRAW);
// scene bounds -> initial camera
let lo=[1/0,1/0,1/0],hi=[-1/0,-1/0,-1/0];
for(let i=0;i<PTS.length;i+=3)for(let k=0;k<3;k++){
lo[k]=Math.min(lo[k],PTS[i+k]);hi[k]=Math.max(hi[k],PTS[i+k]);}
const ctr=[(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
const diag=Math.hypot(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2])||1;
let az=0.6, el=0.4, dist=diag*1.6, pan=[0,0,0];
function mat(){
const w=canvas.width,h=canvas.height,f=1.6,n=diag*1e-3,fa=diag*40;
const a=w/h;
const P=[f/a,0,0,0, 0,f,0,0, 0,0,(fa+n)/(n-fa),-1, 0,0,2*fa*n/(n-fa),0];
const ce=Math.cos(el),se=Math.sin(el),ca=Math.cos(az),sa=Math.sin(az);
const eye=[ctr[0]+pan[0]+dist*ce*sa, ctr[1]+pan[1]+dist*se, ctr[2]+pan[2]+dist*ce*ca];
const at=[ctr[0]+pan[0],ctr[1]+pan[1],ctr[2]+pan[2]];
let z=[eye[0]-at[0],eye[1]-at[1],eye[2]-at[2]];
let zl=Math.hypot(...z);z=z.map(v=>v/zl);
let x=[z[2],0,-z[0]];let xl=Math.hypot(...x)||1;x=x.map(v=>v/xl);
const y=[z[1]*x[2]-z[2]*x[1],z[2]*x[0]-z[0]*x[2],z[0]*x[1]-z[1]*x[0]];
const V=[x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
-(x[0]*eye[0]+x[1]*eye[1]+x[2]*eye[2]),
-(y[0]*eye[0]+y[1]*eye[1]+y[2]*eye[2]),
-(z[0]*eye[0]+z[1]*eye[1]+z[2]*eye[2]),1];
// P*V (column-major)
const M=new Float32Array(16);
for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
for(let k=0;k<4;k++)s+=P[k*4+j]*V[i*4+k];M[i*4+j]=s;}
return M;}
function draw(){
canvas.width=innerWidth*devicePixelRatio;canvas.height=innerHeight*devicePixelRatio;
gl.viewport(0,0,canvas.width,canvas.height);
gl.clearColor(0.063,0.075,0.102,1);gl.enable(gl.DEPTH_TEST);
gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
const M=mat();
gl.useProgram(pPts);
gl.uniformMatrix4fv(gl.getUniformLocation(pPts,"mvp"),false,M);
let lp=gl.getAttribLocation(pPts,"p");gl.bindBuffer(gl.ARRAY_BUFFER,bufP);
gl.enableVertexAttribArray(lp);gl.vertexAttribPointer(lp,3,gl.FLOAT,false,0,0);
let lc=gl.getAttribLocation(pPts,"c");gl.bindBuffer(gl.ARRAY_BUFFER,bufC);
gl.enableVertexAttribArray(lc);gl.vertexAttribPointer(lc,3,gl.UNSIGNED_BYTE,true,0,0);
gl.drawArrays(gl.POINTS,0,PTS.length/3);
gl.useProgram(pLin);
gl.uniformMatrix4fv(gl.getUniformLocation(pLin,"mvp"),false,M);
let ll=gl.getAttribLocation(pLin,"p");gl.bindBuffer(gl.ARRAY_BUFFER,bufL);
gl.enableVertexAttribArray(ll);gl.vertexAttribPointer(ll,3,gl.FLOAT,false,0,0);
gl.drawArrays(gl.LINES,0,CAM.length/3);
requestAnimationFrame(draw);}
let drag=false,panning=false,px=0,py=0;
canvas.addEventListener("mousedown",e=>{drag=true;panning=e.shiftKey||e.button===2;
px=e.clientX;py=e.clientY;});
addEventListener("mouseup",()=>drag=false);
addEventListener("mousemove",e=>{if(!drag)return;
const dx=e.clientX-px,dy=e.clientY-py;px=e.clientX;py=e.clientY;
if(panning){pan[0]-=dx*dist*0.0015;pan[1]+=dy*dist*0.0015;}
else{az-=dx*0.008;el=Math.max(-1.55,Math.min(1.55,el+dy*0.008));}});
canvas.addEventListener("wheel",e=>{e.preventDefault();
dist*=Math.exp(e.deltaY*0.0012);},{passive:false});
canvas.addEventListener("contextmenu",e=>e.preventDefault());
draw();
</script></body></html>
"""


def export_webgl(scene, path, colors=None):
    """Self-contained HTML WebGL scene viewer
    (software/SfM/SfMWebGLViewer/ + main_openMVG2WebGL.cpp counterpart):
    point cloud + camera frusta with orbit/pan/zoom controls, all data
    embedded base64 (no external assets — works offline via file://)."""
    import base64

    from openmvg_torch.geometry.frustum import frustum_corners

    X = np.asarray(scene.X[scene.X_valid], np.float32)
    if colors is None:
        # height colormap fallback (colorize CLI can pass real colors)
        if len(X):
            h = X[:, 1]
            t = (h - h.min()) / max(float(np.ptp(h)), 1e-9)
            colors = np.stack([64 + 160 * t, 96 + 80 * (1 - t),
                               200 - 140 * t], 1).astype(np.uint8)
        else:
            colors = np.zeros((0, 3), np.uint8)
    else:
        colors = np.asarray(colors, np.uint8)
        if len(colors) == scene.n_landmarks:
            colors = colors[np.asarray(scene.X_valid)]
    # camera frusta as line segments (8 edges per camera)
    scale = 0.05 * (np.linalg.norm(X.max(0) - X.min(0)) if len(X) else 1.0)
    segs = []
    for v in _posed_views(scene):
        pid = scene.view_pose[v]
        iid = int(scene.view_intrinsic[v])
        K = _K_of(scene, iid)
        R, C = scene.pose_R[pid], scene.pose_C[pid]
        w, h = int(scene.cameras.width[iid]), int(scene.cameras.height[iid])
        far = np.asarray(frustum_corners(K, R, C, w, h, 1e-3 * scale, scale))[4:]
        for a, b in ((0, 1), (1, 2), (2, 3), (3, 0)):
            segs += [far[a], far[b]]
        for corner in far:
            segs += [C, corner]
    cam = (np.asarray(segs, np.float32) if segs
           else np.zeros((0, 3), np.float32))

    b64 = lambda a: base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()
    html = (_WEBGL_TEMPLATE
            .replace("__NPTS__", str(len(X)))
            .replace("__NCAMS__", str(len(segs) // 16))
            .replace("__PTS__", b64(X))
            .replace("__COL__", b64(colors))
            .replace("__CAM__", b64(cam)))
    with open(path, "w") as f:
        f.write(html)
    return True
