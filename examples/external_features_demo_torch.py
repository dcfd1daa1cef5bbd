"""External feature/match injection demo for the PyTorch port (counterpart
of examples/external_features_demo.py, which writes through openmvg_tpu).

Shows the injection contract: ANY external detector/descriptor/matcher can
feed the pipeline by writing per-view `.feat`/`.desc` files plus a
`matches.bin` through `openmvg_torch.io`, then resuming with the port's
CLI (add `--device cpu` to each stage on a machine without a card):

    python examples/external_features_demo_torch.py -i out/sfm_data.json -m matches
    python -m openmvg_torch.cli filter -i out/sfm_data.json \
        -m matches/matches.putative.bin -o matches/matches.f.bin
    python -m openmvg_torch.cli sfm -i out/sfm_data.json -m matches \
        -M matches/matches.f.bin -o recon

The detector is the same Harris corners + normalized patch descriptors in
plain torch (CPU) as the reference demo's, so both demos write the same
files for the same scene: the point is the file contract, not the
detector.
"""

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F


def harris_patch_features(img_gray, n_feats=512, patch=16, seed=0):
    """(N,4) keypoints [x, y, scale, orient] + (N,128) u8 descriptors."""
    t = torch.as_tensor(img_gray, dtype=torch.float32)[None, None]
    sobel_x = torch.tensor([[[[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]]],
                           dtype=torch.float32)
    ix = F.conv2d(t, sobel_x, padding=1)
    iy = F.conv2d(t, sobel_x.transpose(-1, -2), padding=1)
    w = torch.ones((1, 1, 5, 5)) / 25.0
    sxx = F.conv2d(ix * ix, w, padding=2)
    syy = F.conv2d(iy * iy, w, padding=2)
    sxy = F.conv2d(ix * iy, w, padding=2)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    harris = (det - 0.04 * tr * tr)[0, 0]
    # non-max suppression + border margin
    nms = F.max_pool2d(harris[None, None], 5, stride=1, padding=2)[0, 0]
    m = patch // 2 + 1
    mask = torch.zeros_like(harris, dtype=torch.bool)
    mask[m:-m, m:-m] = True
    cand = torch.nonzero((harris == nms) & mask & (harris > 0))
    if len(cand) == 0:
        return np.zeros((0, 4), np.float32), np.zeros((0, 128), np.uint8)
    scores = harris[cand[:, 0], cand[:, 1]]
    order = torch.argsort(scores, descending=True)[:n_feats]
    yx = cand[order].float()
    # descriptor: 16x16 patch -> fixed random projection to 128-d, L2 norm
    patches = torch.stack([
        t[0, 0, int(y) - patch // 2:int(y) + patch // 2,
          int(x) - patch // 2:int(x) + patch // 2].reshape(-1)
        for y, x in yx])
    patches = patches - patches.mean(1, keepdim=True)
    g = torch.Generator().manual_seed(seed)
    proj = torch.randn(patch * patch, 128, generator=g) / np.sqrt(patch * patch)
    d = patches @ proj
    d = d / d.norm(dim=1, keepdim=True).clamp(min=1e-9)
    d_u8 = ((d + 1) * 0.5 * 255).round().clamp(0, 255).to(torch.uint8)
    kps = np.stack([yx[:, 1].numpy(), yx[:, 0].numpy(),
                    np.full(len(yx), 1.0, np.float32),
                    np.zeros(len(yx), np.float32)], 1)
    return kps.astype(np.float32), d_u8.numpy()


def match_all_pairs(descs, ratio=0.9):
    """Brute-force torch cdist 2-NN + ratio over all view pairs."""
    out = {}
    for i in range(len(descs)):
        for j in range(i + 1, len(descs)):
            if len(descs[i]) < 2 or len(descs[j]) < 2:
                continue
            a = torch.as_tensor(descs[i], dtype=torch.float32)
            b = torch.as_tensor(descs[j], dtype=torch.float32)
            d = torch.cdist(a, b)
            val, idx = torch.topk(d, 2, largest=False)
            keep = val[:, 0] < ratio * val[:, 1]
            rows = torch.nonzero(keep)[:, 0]
            if len(rows):
                out[(i, j)] = np.stack(
                    [rows.numpy(), idx[rows, 0].numpy()], 1).astype(np.int64)
    return out


def main(argv=None):
    import json

    from openmvg_torch.io.features_io import save_descs, save_feats
    from openmvg_torch.io.image import read_image
    from openmvg_torch.io.matches_io import save_matches
    from openmvg_torch.io.sfm_data import load_sfm_data

    p = argparse.ArgumentParser()
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-m", "--matches_dir", required=True)
    p.add_argument("-n", "--n_feats", type=int, default=512)
    p.add_argument("-r", "--ratio", type=float, default=0.9)
    args = p.parse_args(argv)

    scene = load_sfm_data(args.input_file)
    os.makedirs(args.matches_dir, exist_ok=True)
    descs = []
    for v in range(scene.n_views):
        img = np.asarray(read_image(
            os.path.join(scene.root_path, scene.view_filename[v])),
            np.float32)
        if img.ndim == 3:
            img = img.mean(-1)
        kps, d = harris_patch_features(img, n_feats=args.n_feats)
        base = os.path.splitext(scene.view_filename[v])[0]
        save_feats(os.path.join(args.matches_dir, base + ".feat"), kps)
        save_descs(os.path.join(args.matches_dir, base + ".desc"), d)
        descs.append(d)
        print(f"{scene.view_filename[v]}: {len(kps)} features")
    with open(os.path.join(args.matches_dir, "image_describer.json"), "w") as f:
        json.dump({"image_describer": {"type": "EXTERNAL"},
                   "regions_type": {"scalar": "uint8", "dim": 128}}, f)
    matches = match_all_pairs(descs, args.ratio)
    save_matches(matches, os.path.join(args.matches_dir,
                                       "matches.putative.bin"))
    print(f"{len(matches)} matched pairs, "
          f"{sum(len(m) for m in matches.values())} putative matches")


if __name__ == "__main__":
    main()
