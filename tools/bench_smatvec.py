#!/usr/bin/env python3
"""Kernel K3 (the fused S-matvec, openmvg_torch/ops/smatvec.py) at the
final GLOBAL bundle adjustment of the main path, on one NVIDIA card.

    python3 tools/bench_smatvec.py --make-scene DIR [--views 100 --size 1024]
        renders the textured-sphere dataset on the card and runs the port's
        init -> features (HIGH) -> pairs (CONTIGUOUS 6) -> matches (0.8) ->
        filter -g e -> sfm -s GLOBAL, the stages and flags of
        chip_smoke.py's global phase; keeps the reconstruction
        as DIR/sfm_data.json.gz and measures K3 on it
    python3 tools/bench_smatvec.py --scene DIR/sfm_data.json.gz [--tree T ...]
        measures K3 on that reconstruction's final bundle adjustment, once
        for each --tree (a directory whose openmvg_torch is imported; the
        default is this checkout), each in a fresh process, in the order
        given: to compare two trees, give them as A B B A

Each measurement prints one JSON line: CUDA-event ms over back-to-back
calls, the device-only ms of every kernel whose name holds "smatvec" (the
measure of chip_smoke.py::device_ms) and each kernel's own share, launches
a call, max |err| against the float64 plain version, two calls bitwise
equal, the bound (chip_smoke.py::smatvec_bound_ms), the unfused matvec's
ms, and the card's name and power limit.  Exits non-zero without a card.
"""

import argparse
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else None


def device_by_name(fn, reps, key):
    """Device ns of each kernel whose name holds `key`, summed over `reps`
    calls (torch.profiler), as {name: (launches, ms a call)}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and key in e.name():
            n, d = out.get(e.name(), (0, 0))
            out[e.name()] = (n + 1, d + e.duration_ns())
    return {k[:80]: (n, d / 1e6 / reps) for k, (n, d) in out.items()}


def measure(scene_gz):
    """One measurement in this process (the caller put the tree first on
    sys.path)."""
    import importlib.util

    import torch

    # this checkout's chip_smoke.py, whichever tree's openmvg_torch is measured
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from openmvg_torch.io.sfm_data import load_sfm_data
    from openmvg_torch.ops import seg_sum, smatvec
    from openmvg_torch.sfm import ba

    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    seg_sum.build()
    smatvec.build()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sfm_data.json")
        with gzip.open(scene_gz, "rb") as fi, open(path, "wb") as fo:
            shutil.copyfileobj(fi, fo)
        scene = load_sfm_data(path)
    p, _, _, _, args, plan = cs.k3_final_inputs(smatvec, cs.final_problem(scene))
    Jp6, Ji8, Jx3, vp, vi, Hinv = args[0], args[1], args[2], args[5], args[6], args[7]
    n0 = smatvec.LAUNCHES
    got = smatvec.smatvec(*args, plan=plan)
    per_call = smatvec.LAUNCHES - n0
    again = smatvec.smatvec(*args, plan=plan)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    err = cs.smatvec_check(smatvec, got, args)

    def call():
        return smatvec.smatvec(*args, plan=plan)

    ms = cs.cuda_ms(call, 200)
    dev_ms, n_k = cs.device_ms(call, 50, "smatvec")
    by_name = device_by_name(call, 50, "smatvec")
    unfused_ms = cs.cuda_ms(lambda: cs.unfused_matvec(ba, p, Jp6, Ji8, Jx3, Hinv, vp, vi), 50)
    t = p.pt_obs
    O, L1, M, L = Jp6.shape[0], t.row_point.shape[0], t.groups.shape[1], Hinv.shape[0]
    P, I = vp.shape[0], vi.shape[0]
    bound, by = cs.smatvec_bound_ms(O, L1, L, M, P, I)
    floor = getattr(cs, "smatvec_design_floor_ms", None)
    print(json.dumps({
        "tree": os.path.dirname(os.path.dirname(os.path.abspath(smatvec.__file__))),
        "ms": ms, "device_ms": dev_ms, "device_launches_in_50_calls": n_k,
        "device_by_kernel": by_name, "launches_per_call": per_call,
        "max_abs_err": err, "repeatable": same, "bound_ms": bound, "bound_by": by,
        "design_floor_ms": floor(O, L, P, I) if floor else None,
        "unfused_ms": unfused_ms,
        "shape": {"O": O, "R": O // L1, "L1": L1, "L": L, "M": M, "P": P, "I": I},
        "card": smi()}), flush=True)
    if err is None or not same:
        cs.fail("K3 disagrees with its plain version or does not repeat")


def make_scene(out_dir, n_views, size):
    """The global phase's stages (chip_smoke.py), their gates left to
    chip_smoke.py; writes out_dir/sfm_data.json.gz."""
    import math

    import torch

    from openmvg_torch import cli
    from openmvg_torch.utils.synthetic import render_textured_sphere_dataset

    if not torch.cuda.is_available():
        print("no CUDA card", flush=True)
        sys.exit(1)
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="omt_k3_scene_") as work:
        focal = 1.2 * size
        imgdir, _, _, _, _ = render_textured_sphere_dataset(
            work, n_views=n_views, size=size, focal=focal, seed=1,
            arc_step=min(2 * math.pi / n_views, 0.063), device="cuda")
        out, md = os.path.join(work, "out"), os.path.join(work, "matches")
        sfm, recon = os.path.join(out, "sfm_data.json"), os.path.join(work, "recon")
        stages = [
            ["init", "-i", imgdir, "-o", out, "-f", str(focal), "-c", "1"],
            ["features", "-i", sfm, "-o", md, "-p", "HIGH"],
            ["pairs", "-i", sfm, "-m", "CONTIGUOUS", "-c", "6", "-o",
             os.path.join(md, "pairs.txt")],
            ["matches", "-i", sfm, "-o", os.path.join(md, "matches.putative.bin"),
             "-p", os.path.join(md, "pairs.txt"), "-r", "0.8"],
            ["filter", "-i", sfm, "-m", os.path.join(md, "matches.putative.bin"),
             "-o", os.path.join(md, "matches.e.bin"), "-g", "e"],
            ["sfm", "-i", sfm, "-m", md, "-M", os.path.join(md, "matches.e.bin"),
             "-o", recon, "-s", "GLOBAL"],
        ]
        for argv in stages:
            t = time.perf_counter()
            if cli.main(argv) != 0:
                print(f"stage {argv[0]} failed", flush=True)
                sys.exit(1)
            print(f"[scene] {argv[0]} {time.perf_counter() - t:.2f} s", flush=True)
        torch.cuda.empty_cache()
        dst = os.path.join(out_dir, "sfm_data.json.gz")
        with open(os.path.join(recon, "sfm_data.json"), "rb") as fi, \
                gzip.open(dst, "wb") as fo:
            shutil.copyfileobj(fi, fo)
    print(f"[scene] wrote {dst} ({os.path.getsize(dst)} bytes)", flush=True)
    return dst


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--make-scene", metavar="DIR")
    ap.add_argument("--scene", metavar="GZ")
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--views", type=int, default=100)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--measure-here", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.measure_here:
        measure(a.scene)
        return
    sys.path.insert(0, ROOT)
    scene = make_scene(a.make_scene, a.views, a.size) if a.make_scene else a.scene
    if scene is None:
        ap.error("give --make-scene DIR or --scene GZ")
    for tree in a.tree or [ROOT]:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.abspath(tree), ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure-here",
                            "--scene", os.path.abspath(scene)], env=env, timeout=900)
        if r.returncode != 0:
            sys.exit(r.returncode)


if __name__ == "__main__":
    main()
