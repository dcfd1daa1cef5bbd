"""Reconstruction quality against ground truth (counterpart:
openmvg_tpu/sfm/eval_quality.py; openMVG main_evalQuality.cpp,
tools_precisionEvaluationToGt.hpp): a 7-DoF similarity (find_rts) aligns
the estimated camera centres onto the ground truth, then per-camera
position error (ground-truth units) and rotation error statistics, and
export_eval_html, their HTML table."""

import os
from typing import Dict

import numpy as np
import torch

from openmvg_torch.geometry import so3
from openmvg_torch.geometry.similarity import find_rts


def _stem(name):
    return os.path.splitext(os.path.basename(name))[0]


def evaluate_against_gt(scene_est, scene_gt, match_by="filename") -> Dict:
    """Align est -> gt; views are matched by file stem (or by index with
    match_by='index').  Float64 on the CPU."""
    if match_by == "filename":
        stems_gt = {_stem(n): i for i, n in enumerate(scene_gt.view_filename)}
        pairs = [(i, stems_gt[_stem(n)]) for i, n in enumerate(scene_est.view_filename)
                 if _stem(n) in stems_gt]
    else:
        pairs = [(i, i) for i in range(min(scene_est.n_views, scene_gt.n_views))]
    est_idx, gt_idx = [], []
    for i, j in pairs:
        pe, pg = scene_est.view_pose[i], scene_gt.view_pose[j]
        if (0 <= pe < scene_est.n_poses and scene_est.pose_valid[pe]
                and pg >= 0 and scene_gt.pose_valid[pg]):
            est_idx.append(pe)
            gt_idx.append(pg)
    if len(est_idx) < 3:
        return dict(n_common=len(est_idx), ok=False)

    C_est = torch.as_tensor(scene_est.pose_C[est_idx], dtype=torch.float64)
    C_gt = np.asarray(scene_gt.pose_C[gt_idx], np.float64)
    sim = find_rts(C_est[None], torch.as_tensor(C_gt)[None])
    C_al = sim.apply(C_est[None])[0].numpy()
    pos_err = np.linalg.norm(C_al - C_gt, axis=1)
    R_sim = sim.R[0].numpy()
    R_al = np.einsum("nij,jk->nik", scene_est.pose_R[est_idx], R_sim.T)
    ang = so3.relative_rotation_angle_deg(
        torch.as_tensor(R_al), torch.as_tensor(np.asarray(scene_gt.pose_R[gt_idx]))).numpy()
    return dict(
        ok=True,
        n_common=len(est_idx),
        position_error_mean=float(pos_err.mean()),
        position_error_median=float(np.median(pos_err)),
        position_error_max=float(pos_err.max()),
        position_rmse=float(np.sqrt((pos_err ** 2).mean())),
        rotation_error_mean_deg=float(ang.mean()),
        rotation_error_median_deg=float(np.median(ang)),
        scale=float(sim.scale[0]),
        per_camera=dict(pose=[int(p) for p in est_idx],
                        position_error=[float(e) for e in pos_err],
                        rotation_error_deg=[float(a) for a in ang]),
    )


def export_eval_html(stats: Dict, path: str, title="GT evaluation"):
    """The per-camera error table and histograms as HTML
    (tools_precisionEvaluationToGt.hpp exportToHtml); the reference's text
    for the same stats."""
    from openmvg_torch.utils.report import _svg_histogram

    pc = stats.get("per_camera", {})
    pos = pc.get("position_error", [])
    rot = pc.get("rotation_error_deg", [])
    rows = "".join(f"<tr><td>{i}</td><td>{p:.6f}</td><td>{r:.4f}</td></tr>"
                   for i, (p, r) in enumerate(zip(pos, rot)))
    summary = "".join(f"<li>{k}: {v}</li>" for k, v in stats.items() if not isinstance(v, dict))
    html = f"""<!DOCTYPE html><html><head><title>{title}</title></head><body>
<h1>{title}</h1>
<ul>{summary}</ul>
{_svg_histogram(pos, title="camera position error") if pos else ""}
{_svg_histogram(rot, title="camera rotation error (deg)") if rot else ""}
<table border="1"><tr><th>#</th><th>position err</th><th>rotation err (deg)</th></tr>
{rows}</table>
</body></html>"""
    with open(path, "w") as f:
        f.write(html)
    return True
