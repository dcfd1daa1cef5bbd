"""HTML reconstruction report (counterpart: openmvg_tpu/utils/report.py;
openMVG sfm/sfm_report.cpp Generate_SfM_Report): the scene's counts,
reprojection rmse, the engine's stage seconds and SVG histograms of the
residual norms and track lengths, as one standalone HTML file.  Host
numpy; the same text as the reference's for the same scene and stage
times.
"""

import numpy as np

from openmvg_torch.sfm.scene import reprojection_residuals, rmse


def _svg_histogram(values, bins=20, width=560, height=220, title=""):
    if len(values) == 0:
        return "<svg/>"
    hist, edges = np.histogram(values, bins=bins)
    peak = max(hist.max(), 1)
    bar_w = width / bins
    rects = []
    for i, h in enumerate(hist):
        bh = h / peak * (height - 40)
        rects.append(f'<rect x="{i * bar_w:.1f}" y="{height - 20 - bh:.1f}" '
                     f'width="{bar_w - 2:.1f}" height="{bh:.1f}" fill="#4878CF"/>')
    labels = (f'<text x="4" y="14" font-size="12">{title}</text>'
              f'<text x="4" y="{height - 4}" font-size="10">{edges[0]:.2f}</text>'
              f'<text x="{width - 50}" y="{height - 4}" font-size="10">'
              f'{edges[-1]:.2f}</text>')
    return (f'<svg width="{width}" height="{height}" '
            f'xmlns="http://www.w3.org/2000/svg">' + "".join(rects) + labels + "</svg>")


def _stage_table(stage_times):
    if not stage_times:
        return ""
    rows = "".join(f'<tr><td>{k}</td><td>{v:.3f}</td></tr>'
                   for k, v in sorted(stage_times.items(), key=lambda kv: -kv[1]))
    return ('<h2>Per-stage timing (s)</h2>'
            '<table border="1" cellpadding="4">' + rows + "</table>")


def generate_sfm_report(scene, path, title="SfM report", stage_times=None):
    """Write the report to `path`.  stage_times None takes the engine's
    utils.logging.stage_times of this process."""
    if stage_times is None:
        from openmvg_torch.utils import logging as omt_logging

        stage_times = dict(omt_logging.stage_times)
    r, _ = reprojection_residuals(scene)
    norms = np.linalg.norm(r, axis=1) if len(r) else np.zeros(0)
    track_len = (np.bincount(scene.obs_landmark[scene.obs_valid])
                 if scene.n_observations else np.zeros(0))
    track_len = track_len[track_len > 0]
    html = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>{title}</title></head><body>
<h1>{title}</h1>
<table border="1" cellpadding="4">
<tr><td>views</td><td>{scene.n_views}</td></tr>
<tr><td>estimated poses</td><td>{int(scene.pose_valid.sum())}</td></tr>
<tr><td>landmarks</td><td>{scene.n_landmarks}</td></tr>
<tr><td>observations</td><td>{scene.n_observations}</td></tr>
<tr><td>mean track length</td>
<td>{float(track_len.mean()) if len(track_len) else 0:.2f}</td></tr>
<tr><td>RMSE (px)</td><td>{rmse(scene):.4f}</td></tr>
</table>
{_stage_table(stage_times)}
<h2>Residual norm histogram</h2>
{_svg_histogram(norms, title="reprojection residual (px)")}
<h2>Track length histogram</h2>
{_svg_histogram(track_len, bins=int(track_len.max()) if len(track_len) else 1,
                title="track length")}
</body></html>"""
    with open(path, "w") as f:
        f.write(html)
    return True
