"""Driver of the openMVG pipeline scripts (SfM_SequentialPipeline.py,
SfM_GlobalPipeline.py) on rendered photographs.

Set-up renders the configuration's views from the seed as PNG, builds
(or loads from the checkout's cache) the kernels and host libraries,
and warms the process up with one reconstruction of the first
`warmup_views` views.  The window then runs whole reconstructions back
to back, a closed loop of one job: openmvg_torch.cli.main once a stage,
with the argv of cmd_pipeline, into one output directory, which each
reconstruction moves aside when it ends so that the check can read
them all.  The window's last reconstruction is finished and counted;
recon_s is the window's seconds over its reconstructions.

The check reads every reconstruction of the window with the plain
checks of reference/sfm_check.py against the rendered views, and
compares the numbers that limits/<workload>.json names (the others are
logged).  control() puts the control in the program's place for the
same check: the scene held in TF32, or a planted fault (two views'
poses exchanged; each filtered match's second feature taken from the
previous match).

Each stage's seconds are logged with the process's CPU seconds and the
machine's steal seconds (/proc/stat) over the stage, so that a slow
reconstruction shows whether the process did more work, waited, or
was not given the CPU.
"""

import math
import os
import shutil
import time
from types import SimpleNamespace

from benchmark.gen import sphere
from benchmark.reference import sfm_check


def stages(cfg, traffic, images, out, device):
    """cmd_pipeline's stage argv (openmvg_torch/cli.py), each with --device."""
    md = os.path.join(out, "matches")
    is_global = traffic["engine"].upper() == "GLOBAL"
    recon = os.path.join(out, "reconstruction_global" if is_global
                         else "reconstruction_sequential")
    sfm_json = os.path.join(out, "sfm_data.json")
    st = [
        ["init", "-i", images, "-o", out, "-f", str(cfg["focal"]),
         "-c", str(cfg["camera_model"])],
        ["features", "-i", sfm_json, "-o", md, "-m", cfg["describer"], "-p", cfg["preset"]],
        ["pairs", "-i", sfm_json, "-o", os.path.join(md, "pairs.txt"),
         "-m", cfg["pair_mode"]],
        ["matches", "-i", sfm_json, "-o", os.path.join(md, "matches.putative.bin"),
         "-p", os.path.join(md, "pairs.txt"), "-r", str(cfg["ratio"])],
        ["filter", "-i", sfm_json, "-m", os.path.join(md, "matches.putative.bin"),
         "-o", os.path.join(md, "matches.f.bin"), "-g", traffic["filter"]],
        ["sfm", "-i", sfm_json, "-m", md, "-M", os.path.join(md, "matches.f.bin"),
         "-o", recon, "-s", traffic["engine"]],
        ["color", "-i", os.path.join(recon, "sfm_data.json"),
         "-o", os.path.join(recon, "colorized.ply")],
    ]
    return [s + ["--device", str(device)] for s in st], recon


TF32_BITS = 10
CONTROLS = ("tf32", "poses_swapped", "matches_shifted")
NO_WARMUP = {"warmup_views": 0}


def _steal_s():
    """The machine's steal seconds so far (0 where /proc/stat has none)."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


def _clocks():
    return time.perf_counter(), time.process_time(), _steal_s()


def reconstruct(cfg, traffic, images, out, device, rec, times=None):
    """One reconstruction, stage by stage; returns the failing stage's
    name, or None.  `times`, a dict, gets each stage's (wall, CPU of
    this process, steal of the machine) seconds."""
    from openmvg_torch import cli

    shutil.rmtree(out, ignore_errors=True)
    argvs, _ = stages(cfg, traffic, images, out, device)
    for argv in argvs:
        c0 = _clocks()
        with rec.span("stage." + argv[0]):
            rc = cli.main(argv)
        if times is not None:
            times[argv[0]] = [round(b - a, 4) for a, b in zip(c0, _clocks())]
        if rc != 0:
            return argv[0]
    return None


def build_kernels(device):
    """Build (or load from openmvg_torch/_build/) what the path runs."""
    from openmvg_torch.ops import seg_sum, two_nn
    from openmvg_torch.utils import build

    build.host_library()
    if str(device).startswith("cuda"):
        two_nn.build()
        seg_sum.build()


def setup(cfg, traffic, seed, device, work, log):
    import torch

    t0 = time.perf_counter()
    build_kernels(device)
    build_s = time.perf_counter() - t0
    images = os.path.join(work, "images")
    views = sphere.render_views(images, seed, cfg["n_views"], cfg["width"], cfg["height"],
                                cfg["focal"], cfg["arc_step"], device=device,
                                scene_seed=cfg["scene_seed"], noise_gray=cfg["noise_gray"])
    log(f"rendered {cfg['n_views']} views of {cfg['width']} x {cfg['height']} "
        f"in {time.perf_counter() - t0 - build_s:.3f} s")
    n_warm = traffic["warmup_views"]
    if n_warm:
        warm = os.path.join(work, "warm_images")
        os.makedirs(warm)
        for name in views.names[:n_warm]:
            os.link(os.path.join(images, name), os.path.join(warm, name))
        from benchmark.trace import Recorder

        failed = reconstruct(cfg, traffic, warm, os.path.join(work, "warm"), device,
                             Recorder(False))
        if failed:
            raise RuntimeError(f"warm-up reconstruction failed at {failed}")
        shutil.rmtree(os.path.join(work, "warm"))
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()
    return SimpleNamespace(cfg=cfg, traffic=traffic, images=images, views=views, work=work,
                           device=device, build_s=build_s, done=[], stage_s=[])


def window(state, seconds, rec):
    out = os.path.join(state.work, "out")
    attempted = failed = 0
    t0 = time.perf_counter()
    ends = []
    while True:
        rec.unit = attempted
        times = {"t": round(time.time(), 3)}
        bad = reconstruct(state.cfg, state.traffic, state.images, out, state.device, rec, times)
        state.stage_s.append(times)
        attempted += 1
        rec.units = attempted
        if bad:
            failed += 1
            state.done.append((None, bad))
        else:
            kept = os.path.join(state.work, f"done_{attempted}")
            os.rename(out, kept)
            state.done.append((kept, None))
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    elapsed = time.perf_counter() - t0
    state.unit_s = [b - a for a, b in zip([0.0] + ends, ends)]
    return dict(attempted=attempted, failed=failed, window_s=elapsed,
                metrics={"recon_s": elapsed / attempted})


def readings(state, path):
    """The reference's numbers for one reconstruction's files, with the
    control's alteration (control()) applied to what was read."""
    v = state.views
    _, recon = stages(state.cfg, state.traffic, state.images, path, state.device)
    md = os.path.join(path, "matches")
    stems = [os.path.splitext(n)[0] for n in v.names]
    feats = [sfm_check.load_feats(os.path.join(md, s + ".feat")) for s in stems]
    matches = sfm_check.load_matches(os.path.join(md, "matches.f.bin"))
    scene = sfm_check.load_scene(os.path.join(recon, "sfm_data.json"))
    scene, matches = _ALTER[getattr(state, "control", None)](scene, matches)
    unposed, pose_rmse = sfm_check.pose_errors(scene, v.names, v.C)
    return dict(unposed=unposed, ba_excess=sfm_check.ba_excess(scene), pose_rmse=pose_rmse,
                epi_bad_share=sfm_check.epi_bad_share(matches, feats, v.K, v.R, v.C),
                reproj_rmse_px=sfm_check.reproj_rmse_px(scene))


_ALTER = {
    None: lambda scene, matches: (scene, matches),
    "tf32": lambda scene, matches: (sfm_check.rounded_scene(scene, TF32_BITS), matches),
    "poses_swapped": lambda scene, matches: (sfm_check.swapped_poses(scene), matches),
    "matches_shifted": lambda scene, matches: (scene, sfm_check.shifted_matches(matches)),
}


def control(state, out, name, log):
    """The window's reconstructions as the control `name` reads them
    (CONTROLS); check() then compares them as it does the program's."""
    state.control = name
    return out


def check(state, out, limits, log):
    """Each number, worst over the window's reconstructions, beside its
    limit (every limit is an upper one; a reading that is not a number
    fails)."""
    worst = {k: 0.0 for k in limits}
    for path, bad in state.done:
        if path is None:
            log(f"a reconstruction failed at stage {bad}")
            worst = {k: math.inf for k in limits}
            continue
        got = readings(state, path)
        log("reconstruction " + os.path.basename(path) + ": "
            + ", ".join(f"{k} {got[k]!r}" for k in got))
        worst = {k: max(worst[k], float(got[k]) if math.isfinite(got[k]) else math.inf)
                 for k in limits}
    return {k: dict(value=worst[k], limit=limits[k], ok=bool(worst[k] <= limits[k]))
            for k in limits}
