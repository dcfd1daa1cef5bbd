"""Views of a textured sphere from an arc of cameras, at a photograph's size.

A frozen copy of openmvg_torch/utils/synthetic.py's
render_textured_sphere_dataset, widened from a square frame to a W x H one
with the principal point at the frame's centre, and with its own PNG
writer, so that the benchmark's inputs do not change when the program
does.  Each pixel's ray meets a sphere of radius 1.4, shaded by a sum of
96 random 3D sinusoids evaluated at the hit point: dense texture, exactly
consistent across views.  The scene is one scene, as fountain-P11 is:
its texture comes from numpy with a fixed scene seed.  The run's seed
draws the sensor noise on the sphere, Gaussian in gray levels, from a
torch.Generator on `device`, so that every seed gives the same work on other pixels.
The shading runs in float64 on `device`, in blocks of rows.
"""

import os
import struct
import zlib
from typing import NamedTuple

import numpy as np
import torch


RADIUS = 1.4       # the sphere's, centred at the origin
CAM_RADIUS = 3.0   # the arc's


class Views(NamedTuple):
    names: list      # file names, in view order
    K: np.ndarray    # (3, 3), shared by every view
    R: np.ndarray    # (V, 3, 3) world -> camera
    C: np.ndarray    # (V, 3) camera centres


def look_at(center, target, up=(0.0, 1e-6, 1.0)):
    """World -> camera R with +z toward target, y roughly down."""
    z = np.asarray(target, float) - center
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, float), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)


def arc_poses(n_views, arc_step):
    """Centres and rotations of views at ring angles (v - n/2) * arc_step,
    each looking at the origin."""
    Rs, Cs = [], []
    for v in range(n_views):
        th = (v - n_views / 2) * arc_step
        C = np.array([CAM_RADIUS * np.sin(th), 0.3 * np.sin(2 * th), -CAM_RADIUS * np.cos(th)])
        Rs.append(look_at(C, [0.0, 0.0, 0.0]))
        Cs.append(C)
    return np.stack(Rs), np.stack(Cs)


def texture(seed, n_waves=96, freq_hi=400.0):
    """(k vectors (n, 3), phases (n,), amplitudes (n,)) drawn from the seed."""
    rng = np.random.default_rng(seed)
    freqs = np.exp(rng.uniform(np.log(3.0), np.log(freq_hi), n_waves))
    dirs = rng.normal(size=(n_waves, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    phases = rng.uniform(0, 2 * np.pi, n_waves)
    amps = freqs ** -0.25
    amps /= np.sqrt(np.sum(amps * amps) / 2.0)  # sum of sines -> RMS 1
    return dirs * freqs[:, None], phases, amps * 0.42


def render_view(R, C, focal, width, height, tex, device="cpu", block_rows=256, noise=None):
    """(height, width) uint8 image of the sphere seen from (R, C), as the
    reference writer stores a float image: x 255, clipped, truncated.
    noise: (sigma in gray levels, torch.Generator on `device`) or None."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    kv, ph, am = (t(a) for a in tex)
    Ct, Rt = t(C), t(R)
    xs = (torch.arange(width, dtype=torch.float64, device=device) + 0.5 - width / 2) / focal
    out = np.empty((height, width), np.uint8)
    for y0 in range(0, height, block_rows):
        ys = (torch.arange(y0, min(y0 + block_rows, height), dtype=torch.float64,
                           device=device) + 0.5 - height / 2) / focal
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        d = torch.stack([xx, yy, torch.ones_like(xx)], -1) @ Rt
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        b = d @ Ct
        disc = b * b - (Ct @ Ct - RADIUS * RADIUS)
        tt = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        P = Ct + tt[..., None] * d
        val = 0.5 + torch.sin(P @ kv.T + ph) @ am
        if noise is not None:  # on the sphere only: the background stays black
            val = val + torch.randn(val.shape, generator=noise[1], dtype=torch.float64,
                                    device=device) * (noise[0] / 255.0)
        val = torch.where(disc > 0, val, torch.zeros_like(val))
        val = val.to(torch.float32)
        out[y0:y0 + len(ys)] = (torch.clamp(val, 0, 1) * 255.0).to(torch.uint8).cpu().numpy()
    return out


def write_png(path, img, level=1):
    """8-bit grayscale PNG, filter None on every row."""
    h, w = img.shape

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, level)))
        f.write(chunk(b"IEND", b""))


def render_views(out_dir, seed, n_views, width, height, focal, arc_step, device="cpu",
                 scene_seed=0, noise_gray=0.0):
    """Render n_views views of the scene `scene_seed` into
    out_dir/img_XX.png, with sensor noise drawn from `seed`; returns Views."""
    os.makedirs(out_dir, exist_ok=True)
    tex = texture(scene_seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 64)
    R, C = arc_poses(n_views, arc_step)
    names = []
    for v in range(n_views):
        name = f"img_{v:02d}.png"
        write_png(os.path.join(out_dir, name),
                  render_view(R[v], C[v], focal, width, height, tex, device,
                              noise=(noise_gray, gen) if noise_gray else None))
        names.append(name)
    K = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1.0]])
    return Views(names, K, R, C)
