"""HTML reconstruction report and SVG views (counterpart:
openmvg_tpu/utils/report.py; openMVG sfm/sfm_report.cpp
Generate_SfM_Report): the scene's counts, reprojection rmse, the engine's
stage seconds and SVG histograms of the residual norms and track lengths,
as one standalone HTML file; keypoints, matches and tracks of a pair as
SVG, the pose graph as Graphviz and the adjacency matrix of a match set
as SVG.  Host numpy; the same text as the reference's for the same inputs.
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


def svg_features(image_wh, feats, path, radius_scale=1.0):
    """SVG keypoint visualization (features/svg_features.cpp)."""
    w, h = image_wh
    parts = [f'<svg width="{w}" height="{h}" '
             f'xmlns="http://www.w3.org/2000/svg">']
    for f in np.asarray(feats):
        r = max(float(f[2]) * radius_scale, 1.0) if len(f) > 2 else 2.0
        parts.append(f'<circle cx="{f[0]:.1f}" cy="{f[1]:.1f}" r="{r:.1f}" '
                     f'stroke="yellow" fill="none"/>')
    parts.append("</svg>")
    with open(path, "w") as fo:
        fo.write("".join(parts))
    return True


def svg_matches(wh_a, wh_b, feats_a, feats_b, matches, path):
    """Side-by-side match visualization (matching/svg_matches.cpp)."""
    wa, ha = wh_a
    wb, hb = wh_b
    W = wa + wb
    H = max(ha, hb)
    parts = [f'<svg width="{W}" height="{H}" '
             f'xmlns="http://www.w3.org/2000/svg">',
             f'<rect width="{wa}" height="{ha}" fill="#222"/>',
             f'<rect x="{wa}" width="{wb}" height="{hb}" fill="#333"/>']
    for i, j in np.asarray(matches):
        xa, ya = feats_a[i][:2]
        xb, yb = feats_b[j][:2]
        parts.append(f'<line x1="{xa:.1f}" y1="{ya:.1f}" '
                     f'x2="{wa + xb:.1f}" y2="{yb:.1f}" '
                     f'stroke="green" stroke-width="0.5"/>')
    parts.append("</svg>")
    with open(path, "w") as fo:
        fo.write("".join(parts))
    return True


def svg_tracks(wh_a, wh_b, feats_a, feats_b, track_rows, path):
    """Track visualization across an image pair (export/main_exportTracks.cpp):
    one colored polyline + endpoint circles per track.

    track_rows: iterable of (feat_id_a, feat_id_b)."""
    wa, ha = wh_a
    wb, hb = wh_b
    W, H = wa + wb, max(ha, hb)
    rng = np.random.default_rng(0)
    parts = [f'<svg width="{W}" height="{H}" '
             f'xmlns="http://www.w3.org/2000/svg">',
             f'<rect width="{wa}" height="{ha}" fill="#222"/>',
             f'<rect x="{wa}" width="{wb}" height="{hb}" fill="#333"/>']
    for i, j in np.asarray(track_rows):
        xa, ya = feats_a[int(i)][:2]
        xb, yb = feats_b[int(j)][:2]
        col = "#%02x%02x%02x" % tuple(rng.integers(64, 255, 3))
        parts.append(f'<line x1="{xa:.1f}" y1="{ya:.1f}" '
                     f'x2="{wa + xb:.1f}" y2="{yb:.1f}" '
                     f'stroke="{col}" stroke-width="0.7"/>')
        parts.append(f'<circle cx="{xa:.1f}" cy="{ya:.1f}" r="2" '
                     f'stroke="{col}" fill="none"/>')
        parts.append(f'<circle cx="{wa + xb:.1f}" cy="{yb:.1f}" r="2" '
                     f'stroke="{col}" fill="none"/>')
    parts.append("</svg>")
    with open(path, "w") as fo:
        fo.write("".join(parts))
    return True


def export_pose_graph_dot(pairs, path, weights=None):
    """Graphviz export of the view/pose adjacency graph
    (graph/graph_graphviz_export.hpp, used by the global engine)."""
    lines = ["graph pose_graph {"]
    for k, (i, j) in enumerate(pairs):
        attr = ""
        if weights is not None:
            attr = f' [label="{weights[k]}"]'
        lines.append(f"  n{int(i)} -- n{int(j)}{attr};")
    lines.append("}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return True


def svg_adjacency_matrix(n_views, matches, path, cell=12):
    """View-pair adjacency matrix (ui/ImageGraphViewer counterpart as SVG):
    cell (i, j) shaded by match count; symmetric."""
    counts = np.zeros((n_views, n_views))
    for (i, j), m in matches.items():
        counts[i, j] = counts[j, i] = len(m)
    vmax = counts.max() or 1.0
    size = n_views * cell + 2
    parts = [f'<svg width="{size}" height="{size}" '
             f'xmlns="http://www.w3.org/2000/svg">',
             f'<rect width="{size}" height="{size}" fill="white"/>']
    for i in range(n_views):
        for j in range(n_views):
            if counts[i, j] <= 0:
                continue
            t = counts[i, j] / vmax
            shade = int(255 * (1.0 - 0.85 * t))
            parts.append(
                f'<rect x="{1 + j * cell}" y="{1 + i * cell}" '
                f'width="{cell - 1}" height="{cell - 1}" '
                f'fill="rgb({shade},{shade},255)">'
                f'<title>({i},{j}): {int(counts[i, j])}</title></rect>')
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("".join(parts))
    return path
