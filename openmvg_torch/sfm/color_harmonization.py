"""Global color harmonization over the match graph (counterpart:
openmvg_tpu/sfm/color_harmonization.py; host numpy, as there).

Reference parity: software/colorHarmonize +
color_harmonization/global_quantile_gain_offset_alignment.hpp — per image
a gain g_i and offset o_i per channel such that matched-region color
quantiles agree across every matched pair (10 quantiles a pair), the
reference image at (g, o) = (1, 0).  openMVG solves the L-infinity program
with OSI-CLP; the reference and the port take the same constraints
through an IRLS-L1 least squares.

Two departures from the reference (ROADMAP.md, fault 3.6), both about
many images: the gauge holds the mean gain at 1 and the mean offset at 0,
and the solution is then expressed in the reference image's frame (the
reference pins the reference image alone, and on a ring of 100 views
IRLS-L1 then prefers every other gain at 0: one disconnected image costs
less than the noise of all the others); and a quantile pair at the
intensity limits (0 or 1 on either side, clipped pixels) gives no
constraint, since a clipped value says nothing of the gain.  On exact,
unclipped data both give the reference's answer.
"""

from typing import Dict, Tuple

import numpy as np

N_QUANTILES = 10


def pair_quantiles(samples_a, samples_b):
    """Matched-region color samples -> (Q,) quantile vectors per side."""
    qs = np.linspace(0.05, 0.95, N_QUANTILES)
    return (np.quantile(np.asarray(samples_a, float), qs),
            np.quantile(np.asarray(samples_b, float), qs))


def solve_gain_offset(n_images, pair_data: Dict[Tuple[int, int], tuple],
                      ref_image=0, n_irls=8):
    """pair_data[(i, j)] = (quant_i (Q,), quant_j (Q,)) in [0, 1].

    Returns (gains (N,), offsets (N,)) with image `ref_image` = (1, 0).
    Constraint rows: g_i q_i + o_i - g_j q_j - o_j = 0 for each quantile
    pair inside (0, 1)."""
    rows = [(i, j, a, b) for (i, j), (qi, qj) in pair_data.items()
            for a, b in zip(np.asarray(qi), np.asarray(qj)) if 0 < a < 1 and 0 < b < 1]
    m = len(rows)
    if m == 0:
        return np.ones(n_images), np.zeros(n_images)
    A = np.zeros((m + 2, 2 * n_images))
    for r, (i, j, a, b) in enumerate(rows):
        A[r, 2 * i] = a
        A[r, 2 * i + 1] = 1.0
        A[r, 2 * j] = -b
        A[r, 2 * j + 1] = -1.0
    # gauge: mean gain 1, mean offset 0
    A[m, 0::2] = 1e3 / n_images
    A[m + 1, 1::2] = 1e3 / n_images
    rhs = np.zeros(m + 2)
    rhs[m] = 1e3
    w = np.ones(m + 2)
    x = None
    for _ in range(n_irls):
        x, *_ = np.linalg.lstsq(A * w[:, None], rhs * w, rcond=None)
        w = 1.0 / np.maximum(np.abs(A @ x - rhs), 1e-3)
        w[m:] = 1.0
    g, o = x[0::2], x[1::2]
    gains = np.maximum(g / g[ref_image], 1e-3)
    offsets = (o - o[ref_image]) / g[ref_image] + 0.0   # no -0.0
    return gains, offsets


def harmonize_images(images, gains, offsets):
    """Apply per-image gain/offset (float images)."""
    return [np.clip(np.asarray(im, float) * g + o, 0.0, 1.0)
            for im, g, o in zip(images, gains, offsets)]
