#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (openmvg_torch) on one NVIDIA card.

    python3 chip_smoke.py [--views 100] [--size 1024]

Phases, each of which must pass (any failure exits non-zero before the
last line is printed):

  device    a CUDA card is present; prints nvidia-smi's name and power limit
  build     builds every kernel of the path from the sources in this
            checkout (K1: openmvg_torch/csrc/two_nn.cu, K2:
            openmvg_torch/csrc/seg_sum.cu, K3: openmvg_torch/csrc/smatvec.cu)
            and the host libraries: the f64 polish
            (openmvg_torch/csrc/native.cpp), the JPEG codec
            (openmvg_torch/csrc/jpeg.cpp) and the CPU baselines
            (openmvg_torch/csrc/bench_native.cpp, -march=native), one
            compiler each, in parallel
  kernel    holds K1 against its plain PyTorch version on the card: exact
            equality for uint8 (16 pairs of 4096x4096x128, ragged counts
            with valid_b masking, planted ties and duplicate rows, ties that
            straddle the 128-row A and 256-column B tiles, counts 1, 127,
            129 and 3,562), a stated tolerance for float32; times the
            kernel, the plain version and a one-call PyTorch yardstick
            (cdist + topk, never used by the port).  Holds K2 against its
            plain version for k in {6, 36, 64} and num in {1, 128, 1024}, k 9
            with num 50,000 (beyond the TPU kernel's 1024 segments, as the
            point-side sums of a problem without a group table call it), and
            the edge cases (no rows, every row out of range, segments without
            rows, one segment holding every row), and its fused camera sums
            (camera_jtu, camera_jtj) on J blocks (O, 2, 6) and (O, 2, 8) over
            the same ids: float32 within 1e-5 (1 + S), float64 within 1e-12
            (1 + S), S the sum of magnitudes behind each output
            (seg_sum_check, camera_check), each call exactly one launch, and
            two launches on one input bitwise equal.  Holds K3 against its plain version
            (P in {1, 100, 1500}, I in {1, 8}, R in {4, 8, 16, 32}, points
            over several rows, zero padding slots, sentinel group entries,
            one point holding every observation, a point of more than one
            tile among short tracks, a pose without one): float32 within
            1e-5 (1 + S) of the plain version in float64, S the output's
            sum of magnitudes (smatvec_magnitudes), the e buffer of its
            first launch likewise against smatvec_e_plain, two launches a
            call, and two calls bitwise equal; the same, with K2's point
            sums through a plan of row_point, on a layout without a group
            table at BAL Final's scale (about 35.7 M slots, Ji8 past 2^31
            bytes; phase_k3_no_table_final).  Then the reference's CPU
            2-NN baseline (openmvg_torch.native.bench_match_2nn) on K1's
            headline 16 pairs with 1,024 A rows a pair planted near a B
            row (native_match_check): its index equal to K1's on every row
            whose nearest neighbour is unique, its keep flags equal to d1 <
            0.8^2 d2 on K1's squared distances, with rows kept and rows
            between 0.64 and 0.8, timed beside K1
  pipeline  renders the textured-sphere dataset (100 views of 1024^2, the
            repo's realistic scale) on the card and runs the port's CLI
            init -> features (HIGH) -> pairs (CONTIGUOUS 6) -> matches ->
            filter (f) on cuda, with every kernel's launch count set to 0
            just before and read just after; checks the result against the
            renderer's ground truth (>= 95% of filtered matches within 4 px
            of their epipolar line, >= 90% of pairs kept); then runs the
            matches and filter stages once more under torch.profiler, prints
            each one's device busy share and heaviest device ops, and
            requires the re-run to write the same matches files byte for
            byte
  sfm       the port's sfm -s INCREMENTAL, color and eval on cuda, every
            kernel's launch count set to 0 just before and read just after;
            prints the engine's stage seconds and accepted f64 polish steps
            and requires >= 98 of 100 poses, eval position_rmse <= 0.006
            (0.2% of the 3.0 ring radius), reprojection rmse < 1 px, K2
            launched, >= 1 accepted polish step and one colour per landmark
            and camera in colorized.ply; the fused S-matvec (K3), the
            default for the card's float32 BAs, launched.  Then the reference's CPU LM
            baseline (openmvg_torch.native.bench_ba_lm_step) at the final
            scene's problem, its costs within 1e-10 relative of the f64
            polish's step with the same fixed intrinsics, both timed
  jpeg      the main path on photographs: the pipeline's 100 renders
            re-encoded as .jpg through the port's write_image (encode and
            decode ms an image, and the mean |JPEG - PNG|, printed), then
            init without -f (the focal must be the no-EXIF 1.2 x size),
            features HIGH, pairs, matches, filter f, sfm -s INCREMENTAL
            (written as sfm_data.bin), color and eval, every kernel's
            count set to 0 just before and read just after: the pipeline's
            and the sfm phase's gates, K1 and K2 launched, K3 not, the PNG
            run's features seconds printed beside; K1 and K2 at this run's
            own shapes against their plain versions (K1 on its matches
            batch, exact; K2's camera and generic sums at its final bundle
            adjustment within 1e-5 (1 + S)), each timed beside its bound
            and its library call; and the golden digests: the port's decode of
            tests/torch_data's progressive and restart-marker fixtures, and
            of its encoding of the first one's 257 x 131 pixels in RGB and
            gray, equal to the sha256 of jpeg_digests.json (which a CPU
            test holds against PIL's decode)
  sfm2      sfm -s INCREMENTALV2 --output_format bin on the filter f
            matches of the first 50 views (a cut, printed, shared with
            stellar: init on them and their pairs' matches),
            then color and eval --html reading sfm_data.bin: the sfm gates
            (K3 launched), the reconstruction directory holding sfm_data.bin,
            cloud_and_poses.ply and SfMReconstruction_Report.html, the eval
            HTML written, and convert of the .bin to .json reading back the
            same poses and landmarks exactly
  global    filter -g e on the
            pipeline's putative matches, sfm -s GLOBAL (written as
            sfm_data.bin), color and eval on
            cuda, every kernel's count set to 0 just before and read just
            after; prints the share of pairs the essential filter kept and
            the engine's stage seconds, and holds the sfm phase's gates with
            K2 and K3 both launched
  stellar   sfm -s STELLAR on the
            filter f matches of the first 50 views (a cut, printed: init on
            them and their pairs' matches), color and eval; the sfm gates but the polish
            (STELLAR runs none, and must print 0 steps), K2 and K3 launched;
            prints the pod count and the engine's stage seconds
  matchers  the rest of the matching and filtering layer on the pipeline's
            run directory, each step with every kernel's count set to 0
            just before and read just after: matches -n CASCADEHASHINGL2
            then filter -g f (recall >= 0.90 against BRUTEFORCEL2, >= 90%
            of pairs kept, >= 95% of matches within 4 px of the
            ground-truth epipolar line); filter -g a (the same two gates);
            filter -g f -r, guided matching on K1 (the same gates, and at
            least the plain -g f's matches); the models h, u and o on 256
            synthetic pairs of 400 true correspondences and 100 outliers
            each (every pair kept with more than 85% of the true ones, 80%
            for o, and at most 10% + 2 of the outliers, 15% + 2 for o), then
            on the sphere's putative matches (printed, not gated);
            known-poses on the INCREMENTAL scene (at least half its
            landmarks, rmse < 1 px, K1 launched, and K1 on the stage's own
            pair list and descriptor stack equal to its plain version,
            timed beside cdist + topk in chunks of pairs that fit the card);
            vlad -k 64 -t 10 (every view in a pair, K2 launched, the
            embeddings on the card within 1e-5 of their plain float64
            version, and the Lloyd sums of the codebook's pooled rows by
            their assignments within 1e-5 (1 + S) of seg_sum_plain in
            float64, S the sums of |rows|); kvld-filter on the first
            10 putative pairs (a cut; every pair keeps a match, >= 95%
            within 4 px, one pair's VLD differences on the card within 1e-9
            of the CPU float64 version)
  tools     the rest of the SfM layer and the CLI's tools on the pipeline's
            matches and the INCREMENTAL scene, each step with every kernel's
            count set to 0 just before and read just after: localize 10
            held-out views rendered halfway between ring views (>= 9
            localized, each centre within 0.015 of the renderer's after the
            eval alignment, K2 launched; then K2's camera sums of one
            query's float64 pose-only BA against their plain version within
            1e-12 (1 + S)); refine -n 30 with K3's gate (ba.k3_gate)
            patched to decline, then as by default (the cost does not rise, rmse within 1e-3 px
            of the input's and of each other, eval position_rmse <= 0.006, K2
            in both, K3 only in the second); cluster -n 4 (4 files whose views cover the
            posed views, K2; then the k-means Lloyd sums against
            seg_sum_plain within 1e-5 (1 + S)); geo-register --use_priors on the renderer's
            centres under a planted similarity into ECEF (scale 10, 10%
            outliers; the scale within 1% once the reconstruction's gauge is
            taken out, the median centre within 0.06 of its prior);
            harmonize with planted per-channel gains and offsets on 10 copies
            (undone within 0.05, the other gains within 0.05 of 1, 100 PNGs);
            export in every format (the counts of nvm, colmap, bundler and
            openmvs equal the scene's; undistorted, on a copy with a planted
            radial distortion, 100 PNGs, view 0 within 1 gray level of the CPU
            undistort_image); frustum-filter, change-origin, list-pairs -V and
            -G, convert-matches -a, matches2tracks, split-matches, the SVG
            exports (first 10 pairs) and retrieval-quality of the vlad pairs,
            each count printed equal to the files'; bench-ann --source sift
            --sweep (recall >= 0.90 at top_c 16, K1 launched; then K1 on
            its brute-force inputs, 1,245 float32 queries, against
            two_nn_plain); the L-inf solvers on the 1,000 longest tracks and
            10 views' resections (up to 1,000 points each), on every
            observation the reconstruction kept, on those the L2 scene
            reprojects within 1 px and within 0.5 px (at 0.5 px equal
            to the CPU run within 1e-6 relative; in every set the points
            within 0.01 of the L2 scene; the centres within 0.006 at 0.5 px
            and 0.03 at 1 px of the L2 scene's and of the renderer's after
            the eval alignment);
            --profile DIR on refine, in a process of its own (one trace
            naming K2's kernel and the bundle_adjustment stage)
  multigpu  the sharded paths (openmvg_torch/parallel) on the card, after
            tools and on its 100-view INCREMENTAL scene (K3 must stay
            off when sharded), each
            run with every kernel's count set to 0 just before and read just
            after, on every rank: (a) refine -d 4 -n 30 through the CLI
            twice, plainly (one NCCL rank a card, so as many ranks as cards,
            the clamp printed) and with OMT_DIST_BACKEND=gloo (4 ranks sharing
            the card): the cost does not rise, eval position_rmse <= 0.006
            and within 1e-4 of the single-card refine's, K2 launched on every
            rank, K3 on none; then one spawned group of 4 gloo ranks on the
            card: (b) both sharded BA modes against the same solve in one
            rank on the card, in float64 on the reference test's
            ring_scene(8, 61) with 15 LM iterations (cost within 1e-6
            relative, rotvec within 1e-8) and in float32 on big_ba_problem's
            default (256 poses, 300,000 points, 4.2 M observations; 3 LM
            steps: the costs within 1e-5 relative before the first step and
            1e-4 after each, the accepts printed), K2 on every rank; (c) matches
            --ring_matching on with the pipeline's descriptors and pairs: the
            file byte-identical to the single rank's, K1 once a matched ring
            step (4 - r steps on rank r); (d) scaling-bench -s 1,2,4, its
            JSON printed as ranks sharing one card through the host, which
            is no multi-card scaling; and K1 and K2 at the shapes these
            paths give them, against their plain versions and timed beside
            the bound and the library call (multigpu_shapes): mesh rank 0's
            shard of big_ba_problem in each mode, its point sums (k 3 and 9
            over 300,000 or 75,000 points) through its point plan within
            1e-5 (1 + S) and its fused camera sums, and K1 on one rank's 256
            pairs of scaling-bench's 1,024 x 1,024 x 128 float32 stack
  camera3   the one-command main path as users run it, every flag at its
            default but the focal: pipeline -i images -o run -f <focal>
            (camera model 3 PINHOLE_RADIAL_K3, NORMAL, EXHAUSTIVE pairs,
            filter f, INCREMENTAL, color), then eval, on a cut render of 24
            views of 1024^2 (276 pairs; the cut is printed); every kernel's
            count set to 0 just before the pipeline and read just after;
            >= 23 of 24 poses, position_rmse <= 0.006, rmse < 1 px, K1 and
            K2 launched, the scene's intrinsic PINHOLE_RADIAL_K3 with its
            k1..k3 printed (the images have no distortion); the polish
            steps are printed, not gated (the polish takes one shared
            PINHOLE only); prints each stage's seconds and the peak device
            memory
  describers features -m AKAZE_FLOAT and -m AKAZE_MLDB through the CLI on
            the pipeline's run directory (image_describer.json names, .desc
            of 64 float32 and 60 uint8 values a feature), each matched on the
            CONTIGUOUS pairs with every kernel's count set to 0 just before
            and read just after (FLOAT: one K1 launch at D = 64, held to
            two_nn_batch_plain within 1e-4 (1 + |d|) and timed beside its
            bound and cdist + topk; MLDB: batched Hamming products, the loop's
            first batch equal to a plain popcount 2-NN in every distance,
            match and mask) and filtered with -g f (FLOAT: >= 90%
            of pairs kept, >= 95% within 4 px of the ground-truth epipolar
            line; MLDB: every pair with putative matches, the rest printed);
            one view warped on the card by the reference test's homography
            (12 deg, scale 1.15): >= 30 AKAZE_FLOAT matches, >= 70% of them
            within 3 px of it; FAST, LIOP and DIPOLE (at the view's SIFT
            keypoints) on the card against the CPU run (FAST equal, the
            descriptors within 1e-5), MSER and TBMR (host code) counted and
            timed
  spherical 100 SPHERICAL views of 5376x2688 on the reference ring, about
            300,000 observations of points all around the ring, each seen by
            the 5 to 17 views nearest it (short tracks chained around the
            ring, many across the panoramas' seam), 0.5 px noise, 10% outlier
            matches, pairs up to 3 ring steps apart
            (utils/synthetic.py spherical_room_dataset); filter -g a, then
            sfm -s INCREMENTAL and sfm -s GLOBAL, each with the kernels' counts set to 0 just
            before and read just after: >= 98 poses, position rmse after
            7-DoF alignment <= 0.004 (0.2% of the ring radius), rmse < 1 px,
            K2 and K3 launched, 0 polish steps, no triplet stage
  cubify    one seeded 5376x2688 RGB panorama written as PNG through the CLI's
            cubify on the card; the six faces within 1 gray level of the
            port's CPU run of the same resampler
  vo        60 rendered 1024^2 views of the textured sphere 0.014 rad apart
            (about 5-10 px of motion a frame) through the CLI's vo on the
            card: >= 90% of the frames add a pose, and the median angle
            between estimated and true step directions, both in the first
            camera's frame, is under 10 degrees
  measure   K1 on the matches stage's own descriptor stack and pair list
            (beside its bound, the epilogue floor); K2's fused camera_jtu
            and camera_jtj on the final INCREMENTAL bundle adjustment's own
            Jacobians and plans, beside the unfused sequence they replace
            (products, then one generic K2 call a half), and the generic K2
            on its (O, 6) J^T r and (O, 36) J^T J payloads; K3 on the final
            GLOBAL bundle adjustment's Jacobians, point blocks and tables
            with a random v (beside the unfused matvec it replaces, and the
            launch count of one damped solve each way: unfused C = K2
            launches - 3, fused 3 K2 launches and C calls of K3):
            equality with the plain version, kernel / plain / yardstick
            times (CUDA events, and the device-only kernel time from
            torch.profiler) and the bound (for K1 its epilogue floor, for
            K3 its design floor beside it), for the kernels line

Cut to keep the whole run within 1,050 s of its 1,200 s limit: the
features stage's profiled re-run (the matches and filter stages keep
theirs), the profiled re-runs of the sfm stages (about 80 s each),
camera3's scale: 24 views, not 100 (its exhaustive pairs grow with the
square of the views), and INCREMENTALV2's and STELLAR's: the first 50
views, which pay for the jpeg phase.  The jpeg and GLOBAL runs write their scenes as sfm_data.bin, and
the tools and multigpu phases read and write the INCREMENTAL scene as
.bin, not .json (the same scenes; a 100-view .json takes seconds to
write and read).

The last three lines of standard output are the kernels JSON (each
kernel's launches on the main path, and on the jpeg, sfm2, stellar and
camera3 paths as launches_jpeg, launches_v2, launches_stellar and
launches_camera3, K1's and K2's CPU baselines as cpu_baseline_ms, each
step's of the
tools phase as launches_tools, K1's in the
matchers phase as launches_matchers and K2's in vlad as launches_vlad,
with K1's check and times at known-poses' shape and at AKAZE_FLOAT's
64-d float32 shape, K2's at the VLAD Lloyd sums' shape, the tools phase's
shapes as tools_shapes (K1 at bench-ann's, K2 at localize's camera sums
and at cluster's Lloyd sums), K2's and K3's
launches in the spherical phase, and every kernel's in each multigpu run
by rank as launches_multigpu, with K1's and K2's checks and times at the
multigpu phase's shapes as multigpu_shapes and at the jpeg run's as
jpeg_shapes;
every phase's stage and engine seconds, and each matchers, describers,
spherical, cubify, vo and tools step's seconds and readings), then
nvidia-smi's name and power limit, then
{"ok": true, "device": {...}}.  It imports nothing of JAX or openmvg_tpu.
"""

import argparse
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

H100_INT8_OPS = 1979e12   # dense int8 tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12    # float32 outside the tensor cores
H100_F64_FLOPS = 34e12    # float64 outside the tensor cores
H100_BYTES = 3.35e12      # HBM3 bandwidth
CUT_VIEWS = 50            # INCREMENTALV2's and STELLAR's cut, which pays for the jpeg phase


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds per call from CUDA events around `reps` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps, kernel):
    """Mean device time per call of the kernels whose name contains
    `kernel`, from torch.profiler over `reps` calls, and their launch count
    (None, 0 when the profiler saw none of them)."""
    return device_ms_by_kernel(fn, reps, (kernel,))[kernel]


def device_ms_by_kernel(fn, reps, kernels):
    """device_ms for several kernel names from one torch.profiler session
    over `reps` calls of fn: {name: (ms a call or None, launches)}.  One
    session, because on the H100 a session that followed another in the
    same process lost every launch of a kernel (K1's measure in a call of
    this script read none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    out = {}
    for kernel in kernels:
        durs = [e.duration_ns() for e in events if kernel in e.name()]
        out[kernel] = (sum(durs) / 1e6 / reps if durs else None), len(durs)
    return out


def fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    smi = r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() \
        else f"nvidia-smi unavailable (rc {r.returncode})"
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, timeout=60)
    try:
        mhz = float(r.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        mhz = None
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s); "
        f"max SM clock {mhz} MHz; nvidia-smi: {smi}")
    return smi, mhz


def phase_build(kernels):
    """Every kernel's nvcc and the host libraries' g++ run at once, one
    process per source."""
    from concurrent.futures import ThreadPoolExecutor

    from openmvg_torch.sfm import polish
    from openmvg_torch.utils import build

    t0 = time.perf_counter()
    hosts = [polish.build, build.codec_library, build.bench_library]
    with ThreadPoolExecutor(len(kernels) + len(hosts)) as ex:
        futs = [ex.submit(k["module"].build) for k in kernels] + [ex.submit(h) for h in hosts]
        for f in futs:
            f.result()
    dt = time.perf_counter() - t0
    log("[build] host libraries openmvg_torch/csrc/native.cpp (f64 polish), csrc/jpeg.cpp "
        "(JPEG codec) and csrc/bench_native.cpp (CPU baselines, -march=native) built and "
        "loaded")
    for k in kernels:
        log(f"[build] {k['name']}: {k['source']} built and loaded")
        for line in k["module"].BUILD_LOG.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] {len(kernels)} kernel source(s) and {len(hosts)} host libraries in "
        f"{dt:.2f} s")


def two_nn_bound_ms(descs, counts, pairs, out_elems, int8=True):
    """Least time for the work: each input read once and each output
    written once, against the operations these inputs need (2*na*nb*D per
    pair, at the int8 tensor-core or float32 peak)."""
    c = counts.long()
    na = c[pairs[:, 0].long()]
    nb = c[pairs[:, 1].long()]
    D = descs.shape[-1]
    ops = float((2 * na * nb).sum()) * D
    nbytes = (descs.numel() * descs.element_size() + counts.numel() * 4
              + pairs.numel() * 4 + out_elems * 12)
    t_ops = ops / (H100_INT8_OPS if int8 else H100_F32_FLOPS)
    t_bytes = nbytes / H100_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def two_nn_epilogue_floor_ms(counts, pairs, mhz):
    """K1's epilogue floor: three IMNMX a distance (csrc/two_nn.cu) on the
    integer pipe, 64 a clock on each of the 132 SMs, over sum na * nb
    distances at the card's max SM clock."""
    c = counts.long()
    dists = float((c[pairs[:, 0].long()] * c[pairs[:, 1].long()]).sum())
    return 3 * dists / (132 * 64 * mhz * 1e6) * 1e3 if mhz else None


def library_two_nn(a, b):
    """One PyTorch call per step computing the same function: cdist on f32
    copies, then the two smallest per row.  A yardstick only."""
    import torch

    d = torch.cdist(a.float(), b.float())
    return torch.topk(d, 2, dim=-1, largest=False)


def phase_kernel(two_nn, dev):
    import torch

    g = torch.Generator(device="cpu").manual_seed(0)
    errs = []
    log("[kernel] two_nn: kernel vs plain on the card")

    def u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, generator=g)

    def compare(name, got, ref):
        """Exact equality of d1, d2 and idx1; returns the largest |error|."""
        for x, y, what in zip(got, ref, ("d1", "d2", "idx1")):
            if not torch.equal(x, y):
                fail(f"two_nn {name}: {what} differs in {(x != y).sum().item()} entries")
        return max((got[0] - ref[0]).abs().max().item(), (got[1] - ref[1]).abs().max().item())

    # (a) headline: 16 pairs of 4096 x 4096 x 128 uint8, one launch
    V, N = 16, 4096
    descs = u8(V, N, 128).to(dev)
    counts = torch.full((V,), N, dtype=torch.int32, device=dev)
    pairs = torch.stack([torch.arange(16), (torch.arange(16) + 1) % V], 1).to(torch.int32).to(dev)
    got = two_nn.two_nn_batch(descs, counts, pairs)
    ref = two_nn.two_nn_batch_plain(descs, counts, pairs)
    torch.cuda.synchronize()
    errs.append(compare("(a) 16x4096^2 u8", got, ref))
    headline = (descs, pairs, tuple(x.clone() for x in got))  # for the CPU baseline
    ms = cuda_ms(lambda: two_nn.two_nn_batch(descs, counts, pairs), 10)
    plain_ms = cuda_ms(lambda: two_nn.two_nn_batch_plain(descs, counts, pairs), 2, 1)
    a_all = descs[pairs[:, 0].long()]
    b_all = descs[pairs[:, 1].long()]
    lib_ms = cuda_ms(lambda: library_two_nn(a_all, b_all), 3, 1)
    bound, by = two_nn_bound_ms(descs, counts, pairs, pairs.shape[0] * N)
    log(f"[kernel] (a) 16 pairs 4096x4096x128 u8: exact; kernel {ms:.3f} ms "
        f"({1e3 * ms / 16:.1f} us/pair), plain {plain_ms:.3f} ms, cdist+topk "
        f"{lib_ms:.3f} ms, bound {bound:.4f} ms ({by})")

    # (b) ragged counts through the pair batch, and valid_b masking through
    # the single-pair entry point
    descs_b = u8(3, 3517, 128).to(dev)
    counts_b = torch.tensor([3000, 3517, 1], dtype=torch.int32, device=dev)
    pairs_b = torch.tensor([[0, 1], [1, 0], [0, 2], [2, 1]], dtype=torch.int32, device=dev)
    errs.append(compare("(b) ragged batch", two_nn.two_nn_batch(descs_b, counts_b, pairs_b),
                        two_nn.two_nn_batch_plain(descs_b, counts_b, pairs_b)))
    a, b = descs_b[0, :3000].contiguous(), descs_b[1].contiguous()
    vb = (torch.rand(3517, generator=g) > 0.25).to(dev)
    errs.append(compare("(b) valid_b mask", two_nn.two_nn_fused(a, b, vb),
                        two_nn.two_nn_plain(a, b, vb)))
    ms_b = cuda_ms(lambda: two_nn.two_nn_fused(a, b, vb), 10)
    log(f"[kernel] (b) 3000x3517 u8 ragged + valid_b: exact; kernel {ms_b:.3f} ms")

    # (c) planted ties and duplicate rows, b wider than one 64-row tile
    a = u8(500, 128)
    b = u8(1000, 128)
    b[700] = b[70] = b[7]          # three-way tie across tiles
    b[999] = b[1]
    a[0] = b[70]
    a[1] = b[999]
    a[2:10] = a[2]                 # duplicate rows of a
    a, b = a.to(dev), b.to(dev)
    got = two_nn.two_nn_fused(a, b)
    errs.append(compare("(c) ties", got, two_nn.two_nn_plain(a, b)))
    if got[2][0].item() != 7 or got[2][1].item() != 1 or got[1][0].item() != 0:
        fail("two_nn (c): ties did not resolve to the lowest index")
    log("[kernel] (c) planted ties and duplicates: exact, ties to the lowest index")

    # (e) ties and duplicates that straddle the 128-row A and 256-column B
    # tiles, and counts on either side of them
    a = u8(300, 128)
    b = u8(1000, 128)
    b[200] = b[900] = b[7]
    b[256] = b[511] = b[512] = b[255]
    a[0] = b[900]
    a[1] = b[512]
    a[129] = b[7]
    a[127:131] = a[129]
    a, b = a.to(dev), b.to(dev)
    got = two_nn.two_nn_fused(a, b)
    errs.append(compare("(e) ties across tiles", got, two_nn.two_nn_plain(a, b)))
    if [got[2][r].item() for r in (0, 1, 127, 129, 130)] != [7, 255, 7, 7, 7]:
        fail("two_nn (e): ties across tiles did not resolve to the lowest index")
    descs_f = u8(5, 3562, 128).to(dev)
    counts_f = torch.tensor([1, 127, 129, 3562, 0], dtype=torch.int32, device=dev)
    pairs_f = torch.tensor([(i, j) for i in range(5) for j in range(5)], dtype=torch.int32,
                           device=dev)
    errs.append(compare("(f) counts 1, 127, 129, 3562",
                        two_nn.two_nn_batch(descs_f, counts_f, pairs_f),
                        two_nn.two_nn_batch_plain(descs_f, counts_f, pairs_f)))
    log("[kernel] (e) ties across the A and B tiles, (f) counts 1, 127, 129, 3562 and 0 "
        "(25 pairs, one launch): exact")

    # (d) float32: |d - d_plain| <= 1e-4 (1 + |d|); idx1 equal except near ties
    af = torch.randn(3000, 128, generator=g).to(dev)
    bf = torch.randn(3517, 128, generator=g).to(dev)
    got = two_nn.two_nn_fused(af, bf)
    ref = two_nn.two_nn_plain(af, bf)
    tol = 1e-4 * (1 + ref[0].abs())
    if not ((got[0] - ref[0]).abs() <= tol).all() or \
            not ((got[1] - ref[1]).abs() <= 1e-4 * (1 + ref[1].abs())).all():
        fail("two_nn (d): float32 distances outside 1e-4 (1 + |d|)")
    near_tie = (ref[1] - ref[0]) <= 2e-4 * (1 + ref[0])
    bad = (got[2] != ref[2]) & ~near_tie
    if bad.any():
        fail(f"two_nn (d): {bad.sum().item()} float32 indices differ away from a tie")
    f32_err = max((got[0] - ref[0]).abs().max().item(), (got[1] - ref[1]).abs().max().item())
    ms_d = cuda_ms(lambda: two_nn.two_nn_fused(af, bf), 10)
    t_ops = 2 * 3000 * 3517 * 128 / H100_F32_FLOPS
    t_bytes = ((3000 + 3517) * 128 * 4 + 3000 * 12) / H100_BYTES
    bound_d, by_d = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
    log(f"[kernel] (d) 3000x3517x128 f32: max |err| {f32_err:.3g} within "
        f"1e-4 (1 + |d|); kernel {ms_d:.3f} ms, bound {bound_d:.4f} ms ({by_d})")
    return dict(u8_err=max(errs), f32_err=f32_err, headline_ms=ms,
                headline_plain_ms=plain_ms, headline_lib_ms=lib_ms,
                headline_bound_ms=bound, headline=headline)


def epipolar_check(md, pairs_kept, Rs, Cs, K, size):
    """Share of filtered matches within 4 px of the ground-truth epipolar
    line.  The renderer samples pixel centres at index + 0.5, so in SIFT's
    index coordinates the principal point is size/2 - 0.5."""
    import numpy as np

    from openmvg_torch.io.features_io import load_feats

    Kp = K.copy()
    Kp[0, 2] -= 0.5
    Kp[1, 2] -= 0.5
    Ki = np.linalg.inv(Kp)
    feats = {}
    n_ok = n_all = 0
    for (i, j), m in pairs_kept.items():
        for v in (i, j):
            if v not in feats:
                feats[v] = load_feats(os.path.join(md, f"img_{v:02d}.feat"))
        R = Rs[j] @ Rs[i].T
        t = Rs[j] @ (Cs[i] - Cs[j])
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        F = Ki.T @ tx @ R @ Ki
        x1 = np.c_[feats[i][m[:, 0], :2], np.ones(len(m))]
        x2 = np.c_[feats[j][m[:, 1], :2], np.ones(len(m))]
        l2 = x1 @ F.T
        d = np.abs(np.sum(l2 * x2, 1)) / np.hypot(l2[:, 0], l2[:, 1])
        n_ok += int((d <= 4.0).sum())
        n_all += len(m)
    return n_ok, n_all


def profile_stage(name, argv):
    """One CLI stage under torch.profiler (device activity only): prints its
    wall time, the device busy time (the kernels' and copies' own time; one
    stream, so they do not overlap) and the heaviest device ops.  The raw
    event list is summed directly: building the profiler's per-op tables
    for the sfm stage's ~10^6 device events took minutes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from openmvg_torch import cli

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        if cli.main(argv) != 0:
            fail(f"stage {name} returned non-zero under the profiler")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, d = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (n + 1, d + e.duration_ns())
    if not by_name:
        log(f"[profile] {name}: wall {wall:.2f} s; device time not measured "
            "(torch.profiler saw no CUDA events)")
        return
    busy = sum(d for _, d in by_name.values()) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    log(f"[profile] {name}: wall {wall:.2f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}%), {sum(n for n, _ in by_name.values())} device "
        "ops; top: " + "; ".join(f"{k[:60]} {d / 1e6:.1f} ms x{n}" for k, (n, d) in top))


def profile_stages(stages):
    """Where each stage's time goes: each stage runs once more (features
    with -f) under torch.profiler, alone in a fresh process.  A process of
    its own because on the H100 a profiler session that followed a large
    one in the same process lost its first events (the matches stage's
    trace once lacked K1 and the descriptor upload)."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = "import sys, chip_smoke; chip_smoke.profile_stage(sys.argv[1], sys.argv[2:])"
    for name, argv in stages:
        argv = argv + ["-f"] if name == "features" else argv
        r = subprocess.run([sys.executable, "-c", code, name, *argv], cwd=here,
                           timeout=600)
        if r.returncode != 0:
            fail(f"the profiled re-run of stage {name} exited with {r.returncode}")


def phase_pipeline(kernel_mods, n_views, size, work):
    import numpy as np
    import torch

    from openmvg_torch import cli
    from openmvg_torch.io.features_io import load_feats
    from openmvg_torch.io.matches_io import load_matches
    from openmvg_torch.utils.synthetic import render_textured_sphere_dataset

    focal = 1.2 * size
    step = min(2 * math.pi / n_views, 0.063)
    t0 = time.perf_counter()
    imgdir, gtdir, Rs, Cs, K = render_textured_sphere_dataset(
        work, n_views=n_views, size=size, focal=focal, seed=1, arc_step=step,
        device="cuda")
    log(f"[pipeline] rendered {n_views} views of {size}^2 on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    out = os.path.join(work, "out")
    md = os.path.join(work, "matches")
    sfm = os.path.join(out, "sfm_data.json")
    stages = [
        ("init", ["init", "-i", imgdir, "-o", out, "-f", str(focal), "-c", "1"]),
        ("features", ["features", "-i", sfm, "-o", md, "-p", "HIGH"]),
        ("pairs", ["pairs", "-i", sfm, "-m", "CONTIGUOUS", "-c", "6",
                   "-o", os.path.join(md, "pairs.txt")]),
        ("matches", ["matches", "-i", sfm, "-o", os.path.join(md, "matches.putative.bin"),
                     "-p", os.path.join(md, "pairs.txt"), "-r", "0.8"]),
        ("filter", ["filter", "-i", sfm, "-m", os.path.join(md, "matches.putative.bin"),
                    "-o", os.path.join(md, "matches.f.bin"), "-g", "f"]),
    ]
    secs = {}
    for m in kernel_mods:        # every kernel's count, just before the path
        m.LAUNCHES = 0
    for name, argv in stages:
        torch.cuda.synchronize()
        t = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        if rc != 0:
            fail(f"stage {name} returned {rc}")
    launches = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in kernel_mods}  # just after
    log("[pipeline] stage seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    if launches["two_nn"] <= 0:
        fail("the matches stage did not launch K1")

    n_feat = [len(load_feats(os.path.join(md, f"img_{v:02d}.feat"))) for v in range(n_views)]
    putative = load_matches(os.path.join(md, "matches.putative.bin"))
    kept = load_matches(os.path.join(md, "matches.f.bin"))
    n_pairs = sum(min(6, n_views - 1 - i) for i in range(n_views))
    n_ok, n_all = epipolar_check(md, kept, Rs, Cs, K, size)
    share = n_ok / max(n_all, 1)
    log(f"[pipeline] mean features/image {np.mean(n_feat):.1f} (min {min(n_feat)}, "
        f"max {max(n_feat)}); mean putative matches/pair "
        f"{sum(len(m) for m in putative.values()) / max(n_pairs, 1):.1f}; "
        f"pairs kept {len(kept)}/{n_pairs}; filtered matches {n_all}, "
        f"{100 * share:.2f}% within 4 px of the ground-truth epipolar line; "
        f"K1 launches {launches['two_nn']}")
    if share < 0.95:
        fail(f"only {100 * share:.2f}% of filtered matches within 4 px of GT epipolar lines")
    if len(kept) < 0.9 * n_pairs:
        fail(f"only {len(kept)} of {n_pairs} pairs kept")

    def files():
        out = {}
        for f in sorted(os.listdir(md)):
            if f.endswith(".bin"):
                with open(os.path.join(md, f), "rb") as fh:
                    out[f] = fh.read()
        return out

    written = files()
    profile_stages([s for s in stages if s[0] in ("matches", "filter")])
    again = files()
    changed = [f for f in written if again.get(f) != written[f]]
    if changed:
        fail(f"the re-run wrote {len(changed)} different file(s), e.g. {changed[:3]}")
    log(f"[pipeline] the re-run wrote the same {len(written)} matches .bin files byte for "
        "byte")

    return dict(secs=secs, launches=launches, **k1_batch_inputs(md, n_views),
                work=work, sfm=sfm, md=md, gtdir=gtdir, gt=(Rs, Cs, K, size),
                imgdir=imgdir, focal=focal)


def k1_batch_inputs(md, n_views):
    """The matches stage's own K1 inputs: the views' descriptors stacked
    (n_views, Nmax, 128) uint8, their counts and the pairs file's pairs."""
    import numpy as np

    from openmvg_torch import cli
    from openmvg_torch.io.features_io import load_descs

    descs = [load_descs(os.path.join(md, f"img_{v:02d}.desc")) for v in range(n_views)]
    stack = np.zeros((n_views, max(len(d) for d in descs), 128), np.uint8)
    for v, d in enumerate(descs):
        stack[v, :len(d)] = d
    pairs = np.asarray(cli.load_pairs_file(os.path.join(md, "pairs.txt")), np.int32)
    return dict(stack=stack, counts=np.asarray([len(d) for d in descs], np.int32), pairs=pairs)


def phase_measure(two_nn, run, dev, mhz, akaze=None, tag="[measure]", profiled=True):
    """K1 at the main path's shapes: the whole matches batch in one launch,
    equal to its plain version; CUDA-event and device-only time, the bound
    and the epilogue floor.  `akaze` (AKAZE_FLOAT's stack, counts and
    pairs) gets its device time from the same profiler session; with
    `profiled` false no session runs and the device time is not
    measured."""
    import torch

    descs = torch.as_tensor(run["stack"], device=dev)
    counts = torch.as_tensor(run["counts"], device=dev)
    pairs = torch.as_tensor(run["pairs"], device=dev)
    P, nmax = pairs.shape[0], descs.shape[1]
    got = two_nn.two_nn_batch(descs, counts, pairs)
    ref = two_nn.two_nn_batch_plain(descs, counts, pairs)
    torch.cuda.synchronize()
    for x, y, what in zip(got, ref, ("d1", "d2", "idx1")):
        if not torch.equal(x, y):
            fail(f"{tag} two_nn on the matches batch: {what} differs")
    ms = cuda_ms(lambda: two_nn.two_nn_batch(descs, counts, pairs), 5, 1)

    def both():
        two_nn.two_nn_batch(descs, counts, pairs)
        if akaze is not None:
            two_nn.two_nn_batch(*akaze)

    names = ("two_nn_u8_kernel", "two_nn_f32_kernel")
    per_kernel = (device_ms_by_kernel(both, 5, names) if profiled
                  else dict.fromkeys(names, (None, 0)))
    dev_ms, n_k = per_kernel["two_nn_u8_kernel"]
    f32_ms, f32_n = per_kernel["two_nn_f32_kernel"]
    if akaze is not None:
        log(f"{tag} two_nn at AKAZE_FLOAT's shape (float32, D 64): device {fmt_ms(f32_ms)}, "
            f"{f32_n} launches in 5 calls")
    floor = two_nn_epilogue_floor_ms(counts, pairs, mhz)
    plain_ms = cuda_ms(lambda: two_nn.two_nn_batch_plain(descs, counts, pairs), 1, 1)

    def library():
        for s in range(0, P, 16):
            pp = pairs[s:s + 16].long()
            library_two_nn(descs[pp[:, 0]], descs[pp[:, 1]])

    lib_ms = cuda_ms(library, 1, 1)
    bound, by = two_nn_bound_ms(descs, counts, pairs, P * nmax)
    log(f"{tag} two_nn on the matches batch ({P} pairs, Nmax {nmax}, "
        f"counts {int(counts.min())}..{int(counts.max())}): exact; kernel "
        f"{ms:.3f} ms (device {fmt_ms(dev_ms)}, {n_k} launches in 5 calls), plain "
        f"{plain_ms:.3f} ms, cdist+topk {lib_ms:.3f} ms, bound {bound:.4f} ms ({by}); "
        f"{bound / ms * 100:.2f}% of the bound; epilogue floor {fmt_ms(floor)}")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by=by, epilogue_floor_ms=floor, akaze_float_device_ms=f32_ms)


class Tee(io.StringIO):
    """Keeps what a stage prints and passes it on."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text):
        self.out.write(text)
        return super().write(text)


def library_seg_sum(vals, ids, num):
    """One PyTorch call per use computing K2's function (index_add_, the
    mask inside the timed call).  A yardstick only: the port never calls it
    (index_add_ adds with atomics on the card, in no fixed order)."""
    import torch

    m = (ids >= 0) & (ids < num)
    return torch.zeros((num, vals.shape[1]), dtype=vals.dtype,
                       device=vals.device).index_add_(0, ids[m], vals[m])


def seg_sum_bound_ms(O, k, num, itemsize):
    """Least time for K2's work: ids (4 B) and vals (k values) read once a
    row, (num, k) written once, against O * k additions at the float32
    (or float64) rate outside the tensor cores."""
    nbytes = O * 4 + O * k * itemsize + num * k * itemsize
    t_bytes = nbytes / H100_BYTES
    t_ops = O * k / (H100_F32_FLOPS if itemsize == 4 else H100_F64_FLOPS)
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def seg_sum_check(seg_sum, got, vals, ids, num, tol):
    """|got - ref| <= tol (1 + S) elementwise, ref the plain version on the
    same inputs in float64 and S the segment's sum of |vals|: the rounding
    of a sum scales with the magnitudes it adds, not with the result, which
    cancels (45,000 float32 rows in one segment round to ~1e-3 where their
    sum is near 0).  Returns the largest |got - ref|."""
    ref = seg_sum.seg_sum_plain(vals.double(), ids, num)
    scale = seg_sum.seg_sum_plain(vals.double().abs(), ids, num)
    err = (got.double() - ref).abs()
    if not bool((err <= tol * (1 + scale)).all()):
        return None
    return err.max().item() if err.numel() else 0.0


def camera_check(seg_sum, kind, got, args, tol):
    """The fused camera sums against their plain version in float64:
    |got - ref| <= tol (1 + S) for both halves, S the sums of the same
    products on |J| and |u|.  Returns the largest |got - ref|, or None."""
    jp, ji, u, pose, intr, P, I = args
    d = [x.double() for x in (jp, ji, u)]
    if kind == "jtu":
        ref = seg_sum.camera_jtu_plain(*d, pose, intr, P, I)
        mag = seg_sum.camera_jtu_plain(*(x.abs() for x in d), pose, intr, P, I)
    else:
        ref = seg_sum.camera_jtj_plain(d[0], d[1], pose, intr, P, I)
        mag = seg_sum.camera_jtj_plain(d[0].abs(), d[1].abs(), pose, intr, P, I)
    worst = 0.0
    for x, r, m in zip(got, ref, mag):
        err = (x.double() - r).abs()
        if x.shape != r.shape or not bool((err <= tol * (1 + m)).all()):
            return None
        worst = max(worst, err.max().item() if err.numel() else 0.0)
    return worst


def camera_call(seg_sum, kind, args, plans=None):
    jp, ji, u, pose, intr, P, I = args
    if kind == "jtu":
        return seg_sum.camera_jtu(jp, ji, u, pose, intr, P, I, plans)
    return seg_sum.camera_jtj(jp, ji, pose, intr, P, I, plans)


def phase_kernel_k2(seg_sum, dev):
    """K2 against its plain version (seg_sum_check, camera_check): float32
    within 1e-5 (1 + S), float64 within 1e-12 (1 + S); each call one
    launch; two launches on one input bitwise equal.  The fused camera sums
    run over the same ids as pose and as intrinsic ids."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(2)
    log("[kernel] seg_sum: kernel vs plain on the card")
    cases = [(f"k{k} num{num}", 50000, k, num, None) for k in (6, 36, 64)
             for num in (1, 128, 1024)]
    cases += [("k9 num50000", 200000, 9, 50000, None),
              ("no rows", 0, 6, 128, None), ("every row out of range", 5000, 36, 128, "out"),
              ("segments without rows", 300, 6, 1024, None),
              ("one segment holds every row", 200000, 64, 1024, "one")]
    errs = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        worst = worst_cam = 0.0
        for name, O, k, num, kind in cases:
            vals = torch.randn((O, k), generator=g, dtype=torch.float64).to(dtype).to(dev)
            ids = torch.randint(0, num, (O,), generator=g)
            out = torch.rand(O, generator=g) < 0.1
            ids[out] = torch.tensor([-1, num, num + 5])[torch.randint(0, 3, (int(out.sum()),),
                                                                      generator=g)]
            if kind == "out":
                ids[:] = num
            elif kind == "one":
                ids[:] = 5
            ids = ids.to(torch.int32).to(dev)
            plan = seg_sum.seg_sum_plan(ids, num)
            before = seg_sum.LAUNCHES
            got = seg_sum.seg_sum(vals, ids, num, plan)
            again = seg_sum.seg_sum(vals, ids, num, plan)
            torch.cuda.synchronize()
            if seg_sum.LAUNCHES != before + 2:
                fail(f"seg_sum {name} {dtype}: {seg_sum.LAUNCHES - before} launches for "
                     "two calls")
            if got.shape != (num, k) or not torch.isfinite(got).all():
                fail(f"seg_sum {name} {dtype}: bad output")
            if not torch.equal(got, again):
                fail(f"seg_sum {name} {dtype}: two launches differ")
            err = seg_sum_check(seg_sum, got, vals, ids, num, tol)
            if err is None:
                fail(f"seg_sum {name} {dtype}: outside {tol:g} (1 + S)")
            worst = max(worst, err)
            # the fused camera sums on J blocks over the same ids
            jp = torch.randn((O, 2, 6), generator=g, dtype=torch.float64).to(dtype).to(dev)
            ji = torch.randn((O, 2, 8), generator=g, dtype=torch.float64).to(dtype).to(dev)
            u = torch.randn((O, 2), generator=g, dtype=torch.float64).to(dtype).to(dev)
            args = (jp, ji, u, ids, ids, num, num)
            plans = (plan, seg_sum.seg_sum_plan(ids, num))   # one plan a half
            for kind in ("jtu", "jtj"):
                before = seg_sum.LAUNCHES
                got = camera_call(seg_sum, kind, args, plans)
                again = camera_call(seg_sum, kind, args, plans)
                torch.cuda.synchronize()
                if seg_sum.LAUNCHES != before + 2:
                    fail(f"camera_{kind} {name} {dtype}: {seg_sum.LAUNCHES - before} "
                         "launches for two calls")
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"camera_{kind} {name} {dtype}: two launches differ")
                if kind == "jtj" and not all(torch.equal(x, x.transpose(-1, -2)) for x in got):
                    fail(f"camera_jtj {name} {dtype}: not symmetric")
                err = camera_check(seg_sum, kind, got, args, tol)
                if err is None:
                    fail(f"camera_{kind} {name} {dtype}: outside {tol:g} (1 + S)")
                worst_cam = max(worst_cam, err)
        errs[str(dtype).split(".")[1]] = worst
        errs["camera_" + str(dtype).split(".")[1]] = worst_cam
        log(f"[kernel] seg_sum {dtype}: {len(cases)} cases within {tol:g} (1 + S), "
            f"max |err| {worst:.3g}; camera_jtu and camera_jtj on the same ids within "
            f"{tol:g} (1 + S), max |err| {worst_cam:.3g}; one launch a call, two launches "
            "bitwise equal in every case")
    return errs


def k3_case(g, P, I, R, L, max_obs, kind):
    """A point-major layout (sfm/ba.py::point_major_layout): point l has
    1..max_obs observations (every point max_obs when kind is "one"; point
    L // 2 5,000 when it is "hub") in ceil(n / R) rows of R slots; slack
    slots carry zero Jacobians and pose 0; group entries past a point's
    rows are the sentinel L1; pose P // 2 has no observation when P > 1.
    Returns the smatvec arguments on the CPU."""
    import torch

    n = torch.full((L,), max_obs) if kind == "one" else torch.randint(1, max_obs + 1, (L,),
                                                                      generator=g)
    if kind == "hub":
        n[L // 2] = 5000
    nrow = (n + R - 1) // R
    L1, M = int(nrow.sum()), int(nrow.max())
    start = torch.cumsum(nrow, 0) - nrow
    row_point = torch.repeat_interleave(torch.arange(L), nrow)
    col = torch.arange(M)[None, :]
    groups = torch.where(col < nrow[:, None], start[:, None] + col, L1)
    O = L1 * R
    slot = torch.arange(O)
    row = slot // R
    used = (row - start[row_point[row]]) * R + slot % R < n[row_point[row]]
    pose = torch.randint(0, P, (O,), generator=g)
    if P > 1:
        pose[pose == P // 2] = (P // 2 + 1) % P
    pose[~used] = 0
    intr = torch.where(used, torch.randint(0, I, (O,), generator=g), 0)
    w = used.float()[:, None, None]
    A = torch.randn((L, 3, 3), generator=g, dtype=torch.float64)
    hinv = torch.linalg.inv(A @ A.transpose(-1, -2) + 3 * torch.eye(3, dtype=torch.float64))
    i32 = torch.int32
    return [torch.randn((O, 2, 6), generator=g) * w, torch.randn((O, 2, 8), generator=g) * w,
            torch.randn((O, 2, 3), generator=g) * w, pose.to(i32), intr.to(i32),
            torch.randn((P, 6), generator=g), torch.randn((I, 8), generator=g),
            hinv.float(), row_point.to(i32), groups.to(i32)]


def smatvec_check(smatvec, got, args):
    """|got - ref| <= 1e-5 (1 + S) elementwise for both halves, ref the
    plain version on the same inputs in float64 and S the sum of
    magnitudes behind each output (smatvec_magnitudes).  Returns the
    largest |got - ref|, or None when outside."""
    d = [a.double() if a is not None and a.is_floating_point() else a for a in args]
    ref = smatvec.smatvec_plain(*d)
    mag = smatvec.smatvec_magnitudes(*d)
    worst = 0.0
    for x, r, m in zip(got, ref, mag):
        err = (x.double() - r).abs()
        if not bool((err <= 1e-5 * (1 + m)).all()):
            return None
        worst = max(worst, err.max().item() if err.numel() else 0.0)
    return worst


def phase_kernel_k3(smatvec, dev):
    """K3 against its plain version (smatvec_check, and its e buffer against
    smatvec_e_plain), two launches a call, and bitwise repeatable."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(3)
    log("[kernel] smatvec: kernel vs plain on the card")
    cases = [("P1 I1 R4", 1, 1, 4, 3000, 6, None),
             ("P100 I1 R8, points over several rows", 100, 1, 8, 20000, 40, None),
             ("P100 I8 R16", 100, 8, 16, 8000, 50, None),
             ("P1500 I8 R32", 1500, 8, 32, 20000, 70, None),
             ("P1500 I1 R4", 1500, 1, 4, 30000, 12, None),
             ("P100 I1 R4, one point holds every observation", 100, 1, 4, 1, 40000, "one"),
             ("P30 I2 R8, a point of 5,000 among short tracks", 30, 2, 8, 5000, 12, "hub")]
    worst = 0.0
    for name, P, I, R, L, max_obs, kind in cases:
        args = [a.to(dev) for a in k3_case(g, P, I, R, L, max_obs, kind)]
        plan = smatvec.smatvec_plan(args[3], args[4], args[8], L, P, I)
        n0 = smatvec.LAUNCHES
        got = smatvec.smatvec(*args, plan=plan)
        if smatvec.LAUNCHES - n0 != 2:
            fail(f"smatvec {name}: {smatvec.LAUNCHES - n0} launches, not two")
        torch.cuda.synchronize()
        d = [a.double() if a.is_floating_point() else a for a in args]
        e_err = (plan.e.double() - smatvec.smatvec_e_plain(*d)).abs()
        if not bool((e_err <= 1e-5 * (1 + smatvec.smatvec_e_magnitudes(*d))).all()):
            fail(f"smatvec {name}: the e buffer is outside 1e-5 (1 + S)")
        again = smatvec.smatvec(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"smatvec {name}: two launches differ")
        if not all(bool(torch.isfinite(x).all()) for x in got):
            fail(f"smatvec {name}: non-finite output")
        if P > 1 and not bool((got[0][P // 2] == 0).all()):
            fail(f"smatvec {name}: the pose without observations got a value")
        err = smatvec_check(smatvec, got, args)
        if err is None:
            fail(f"smatvec {name}: outside 1e-5 (1 + S)")
        worst = max(worst, err)
        log(f"[kernel] smatvec {name}: O {args[0].shape[0]}, max |err| {err:.3g}")
    log(f"[kernel] smatvec float32: {len(cases)} cases within 1e-5 (1 + S), e buffer too, "
        f"max |err| {worst:.3g}; two launches a call, two calls bitwise equal in every case")
    return worst


def k3_no_table_case(dev, seed, P, I, L, max_obs, R):
    """k3_case's point-major layout made on the card, with no group table
    (groups None, as sfm/ba.py::build_pt_obs leaves a problem whose table
    would pass its budget): point l has 1..max_obs observations in
    ceil(n / R) rows of R slots, slack slots zero with pose and intrinsic
    0, pose P // 2 without observations."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    n = torch.randint(1, max_obs + 1, (L,), generator=g, device=dev)
    nrow = (n + R - 1) // R
    start = torch.cumsum(nrow, 0) - nrow
    row_point = torch.repeat_interleave(torch.arange(L, device=dev), nrow)
    O = row_point.shape[0] * R
    row = torch.arange(O, device=dev) // R
    pt = row_point[row]
    used = (row - start[pt]) * R + torch.arange(O, device=dev) % R < n[pt]
    del row, pt
    pose = torch.randint(0, P, (O,), generator=g, device=dev)
    pose[pose == P // 2] = (P // 2 + 1) % P
    pose[~used] = 0
    intr = torch.where(used, torch.randint(0, I, (O,), generator=g, device=dev), 0)
    w = used.float()[:, None, None]
    A = torch.randn((L, 3, 3), generator=g, device=dev, dtype=torch.float64)
    hinv = torch.linalg.inv(A @ A.transpose(-1, -2) + 3 * torch.eye(3, dtype=A.dtype, device=dev))
    i32 = torch.int32
    return [torch.randn((O, 2, k), generator=g, device=dev).mul_(w) for k in (6, 8, 3)] + [
        pose.to(i32), intr.to(i32), torch.randn((P, 6), generator=g, device=dev),
        torch.randn((I, 8), generator=g, device=dev), hinv.float(), row_point.to(i32), None]


def phase_k3_no_table_final(smatvec, seg_sum, dev):
    """K3 planned from row_point alone, and K2's point sums through a plan
    of row_point (what sfm/ba.py runs without a group table), at BAL
    Final's scale: 13,682 cameras with their own intrinsics, 4,456,117
    points of 1..12 observations in rows of 4 slots, about 35.7 M slots,
    so that Ji8 passes 2^31 bytes.  Each against its plain version in
    float64 on the same inputs within 1e-5 (1 + S) (smatvec_check,
    seg_sum_check; K3's e buffer too), two launches a K3 call and one a
    K2 call, two K3 calls bitwise equal."""
    import torch

    P = I = 13682
    L, R = 4456117, 4
    log("[kernel] smatvec without a group table at BAL Final's scale")
    args = k3_no_table_case(dev, 17, P, I, L, 12, R)
    O, L1 = args[0].shape[0], args[8].shape[0]
    ji8_bytes = args[1].numel() * args[1].element_size()
    if ji8_bytes <= 2 ** 31:
        fail(f"smatvec at Final's scale: Ji8 holds {ji8_bytes} B, not past 2^31")
    t0 = time.perf_counter()
    plan = smatvec.smatvec_plan(args[3], args[4], args[8], L, P, I)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    n0 = smatvec.LAUNCHES
    got = smatvec.smatvec(*args, plan=plan)
    launches = smatvec.LAUNCHES - n0
    if launches != 2:
        fail(f"smatvec at Final's scale: {launches} launches, not two")
    e = plan.e.clone()
    again = smatvec.smatvec(*args, plan=plan)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("smatvec at Final's scale: two launches differ")
    del again
    ms = cuda_ms(lambda: smatvec.smatvec(*args, plan=plan), 10)
    bound, by = smatvec_bound_ms(O, L1, L, 0, P, I)
    d = [a.double() if a is not None and a.is_floating_point() else a for a in args]
    e_err = (e.double() - smatvec.smatvec_e_plain(*d)).abs()
    if not bool((e_err <= 1e-5 * (1 + smatvec.smatvec_e_magnitudes(*d))).all()):
        fail("smatvec at Final's scale: the e buffer is outside 1e-5 (1 + S)")
    e_err = e_err.max().item()
    del d, e
    if P > 1 and not bool((got[0][P // 2] == 0).all()):
        fail("smatvec at Final's scale: the pose without observations got a value")
    err = smatvec_check(smatvec, got, args)
    if err is None:
        fail("smatvec at Final's scale: outside 1e-5 (1 + S)")

    g = torch.Generator(device=dev).manual_seed(18)
    point_plan = seg_sum.seg_sum_plan(args[8], L)
    k2 = {}
    for k in (3, 9):
        vals = torch.randn((L1, k), generator=g, device=dev)
        n0 = seg_sum.LAUNCHES
        sums = seg_sum.seg_sum(vals, args[8], L, point_plan)
        if seg_sum.LAUNCHES - n0 != 1:
            fail(f"seg_sum k{k} over Final's rows: {seg_sum.LAUNCHES - n0} launches, not one")
        k2_err = seg_sum_check(seg_sum, sums, vals, args[8], L, 1e-5)
        if k2_err is None:
            fail(f"seg_sum k{k} over Final's rows: outside 1e-5 (1 + S)")
        k2[f"k{k}"] = k2_err
    out = dict(O=O, R=R, L1=L1, L=L, P=P, I=I, ji8_bytes=ji8_bytes, tiles=plan.tiles.shape[0],
               plan_s=plan_s, launches_per_call=launches, max_abs_err=err, e_max_abs_err=e_err,
               ms=ms, bound_ms=bound, bound_by=by,
               point_sums_max_abs_err=k2, point_sums_launches_per_call=1)
    log(f"[kernel] smatvec without a group table (O {O}, R {R}, L1 {L1}, L {L}, P {P}, I {I}, "
        f"{out['tiles']} tiles, Ji8 {ji8_bytes} B): plan {plan_s:.2f} s; within 1e-5 (1 + S), "
        f"max |err| {err:.3g}, e buffer {e_err:.3g}; two launches a call, two calls bitwise "
        f"equal; kernel {ms:.4f} ms by events, "
        f"bound {bound:.4f} ms ({by}), {bound / ms * 100:.2f}% of the bound; K2 point sums "
        f"through a plan of row_point, one launch a call, within 1e-5 (1 + S), max |err| "
        f"k3 {k2['k3']:.3g}, k9 {k2['k9']:.3g}")
    del args, plan, got, point_plan
    torch.cuda.empty_cache()
    return out


def run_stages(kernel_mods, stages):
    """Runs CLI stages on the card, each one's standard output kept (and
    passed on), with every kernel's count set to 0 just before the first
    and read just after the last.  Returns (seconds, printed, launches)."""
    import contextlib

    import torch

    from openmvg_torch import cli

    secs = {}
    printed = {name: Tee(sys.stdout) for name, _ in stages}
    for m in kernel_mods:        # every kernel's count, just before the path
        m.LAUNCHES = 0
    for name, argv in stages:
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed[name]):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        if rc != 0:
            fail(f"stage {name} returned {rc}")
    launches = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in kernel_mods}  # just after
    return secs, printed, launches


SFM_DONE = re.compile(r"SfM done .* (\d+) f64 polish steps, (\d+) rounds(?:, (\d+) pods)?")


def check_reconstruction(tag, scene_path, ply, stats, n_views, need, launches, sfm_out,
                         polish_gate=True, min_poses=None):
    """The gates of the module note on one reconstruction: poses (at least
    min_poses, default 98% of the views), eval
    position_rmse, reprojection rmse, the kernels in `need` launched, the
    f64 polish (unless polish_gate is False) and one colour per landmark
    and camera.  Returns (scene, polish steps, rounds, pods or None)."""
    import numpy as np

    from openmvg_torch.io.ply import load_ply_vertices
    from openmvg_torch.io.sfm_data import load_sfm_data
    from openmvg_torch.sfm.scene import rmse

    done = SFM_DONE.search(sfm_out)
    if done is None:
        fail(f"{tag} the sfm stage printed no summary line")
    polish_steps, rounds = int(done.group(1)), int(done.group(2))
    pods = int(done.group(3)) if done.group(3) else None
    scene = load_sfm_data(scene_path)
    n_posed = int(scene.pose_valid.sum())
    err_px = rmse(scene)
    pts, _ = load_ply_vertices(ply)
    log(f"{tag} {n_posed}/{n_views} poses, {scene.n_landmarks} landmarks, rmse "
        f"{err_px:.4f} px, position_rmse {stats.get('position_rmse')}, "
        f"{polish_steps} accepted f64 polish steps, {rounds} rounds"
        + (f", {pods} pods" if pods is not None else "") + f", launches {launches}")
    if n_posed < (math.ceil(0.98 * n_views) if min_poses is None else min_poses):
        fail(f"{tag} only {n_posed} of {n_views} poses reconstructed")
    if not stats.get("ok") or not stats["position_rmse"] <= 0.006:
        fail(f"{tag} position_rmse {stats.get('position_rmse')} above 0.006")
    if not err_px < 1.0:
        fail(f"{tag} reprojection rmse {err_px:.4f} px is not below 1 px")
    for name in need:
        if launches[name] <= 0:
            fail(f"{tag} the sfm stage did not launch {name}")
    if polish_gate and polish_steps < 1:
        fail(f"{tag} the f64 polish accepted no step")
    if len(pts) != scene.n_landmarks + n_posed or not np.isfinite(pts).all():
        fail(f"{tag} colorized.ply holds {len(pts)} vertices for {scene.n_landmarks} "
             f"landmarks and {n_posed} cameras")
    return scene, polish_steps, rounds, pods


def phase_sfm(kernel_mods, run, n_views, engine="INCREMENTAL", matches="matches.f.bin",
              pre=(), need=("seg_sum",), recon_name="recon", tag="[sfm]", fmt="json",
              html=None, polish_gate=True):
    """[pre stages ->] sfm -> color -> eval on the card, with every kernel's
    count set to 0 just before and read just after, and the gates of the
    module note (check_reconstruction); `need` names the kernels that must
    have launched.  fmt "bin" writes and reads sfm_data.bin; `html` is
    eval's --html file."""
    from openmvg_torch.utils.logging import stage_times

    recon = os.path.join(run["work"], recon_name)
    scene_path = os.path.join(recon, f"sfm_data.{fmt}")
    ply = os.path.join(recon, "colorized.ply")
    stages = list(pre) + [
        ("sfm", ["sfm", "-i", run["sfm"], "-m", run["md"],
                 "-M", os.path.join(run["md"], matches), "-o", recon, "-s", engine]
         + (["--output_format", fmt] if fmt != "json" else [])),
        ("color", ["color", "-i", scene_path, "-o", ply]),
        ("eval", ["eval", "-i", scene_path, "-g", run["gtdir"]]
         + (["--html", html] if html else [])),
    ]
    secs, printed, launches = run_stages(kernel_mods, stages)
    stats = json.loads(printed["eval"].getvalue())
    log(f"{tag} stage seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    log(f"{tag} engine stage seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_times.items()))
    scene, polish_steps, rounds, pods = check_reconstruction(
        tag, scene_path, ply, stats, n_views, need, launches, printed["sfm"].getvalue(),
        polish_gate)
    return dict(secs=secs, launches=launches, engine=dict(stage_times), stats=stats,
                scene=scene, polish_steps=polish_steps, rounds=rounds, pods=pods, recon=recon)


def phase_global(kernel_mods, run, n_views):
    """filter -g e -> sfm -s GLOBAL -> color -> eval, K2 and K3 launched."""
    from openmvg_torch.io.matches_io import load_matches

    md = run["md"]
    putative = os.path.join(md, "matches.putative.bin")
    pre = [("filter", ["filter", "-i", run["sfm"], "-m", putative,
                       "-o", os.path.join(md, "matches.e.bin"), "-g", "e"])]
    res = phase_sfm(kernel_mods, run, n_views, engine="GLOBAL", matches="matches.e.bin",
                    fmt="bin", pre=pre, need=("seg_sum", "smatvec"), recon_name="recon_global",
                    tag="[global]")
    kept = load_matches(os.path.join(md, "matches.e.bin"))
    n_put = len(load_matches(putative))
    res["pairs_kept"] = (len(kept), n_put)
    log(f"[global] filter -g e kept {len(kept)}/{n_put} pairs "
        f"({100 * len(kept) / max(n_put, 1):.1f}%), {sum(len(m) for m in kept.values())} "
        "matches")
    return res


def phase_sfm2(kernel_mods, run, n_views, matches="matches.f.bin"):
    """sfm -s INCREMENTALV2 --output_format bin -> color and eval --html
    reading sfm_data.bin, K3 launched; the sfm phase's gates, the files the
    reconstruction directory must hold, and `convert` of the .bin to
    .json reading back the same poses and landmarks exactly."""
    import numpy as np

    from openmvg_torch import cli
    from openmvg_torch.io.sfm_data import load_sfm_data

    html = os.path.join(run["work"], "eval_v2.html")
    res = phase_sfm(kernel_mods, run, n_views, engine="INCREMENTALV2", matches=matches,
                    recon_name="recon_v2", tag="[sfm2]", fmt="bin", html=html,
                    need=("seg_sum", "smatvec"))
    need = {"sfm_data.bin", "cloud_and_poses.ply", "SfMReconstruction_Report.html"}
    have = set(os.listdir(res["recon"]))
    if not need <= have or not os.path.getsize(html):
        fail(f"[sfm2] missing outputs: {sorted(need - have)}, eval html "
             f"{os.path.exists(html)}")
    src = os.path.join(res["recon"], "sfm_data.bin")
    dst = os.path.join(res["recon"], "converted.json")
    if cli.main(["convert", "-i", src, "-o", dst]) != 0:
        fail("[sfm2] convert returned non-zero")
    a, b = load_sfm_data(src), load_sfm_data(dst)
    for f in ("pose_valid", "pose_R", "pose_C", "X_valid", "X", "obs_landmark", "obs_view",
              "obs_x", "obs_feat"):
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            fail(f"[sfm2] convert .bin -> .json changed {f}")
    log(f"[sfm2] {sorted(have)} written; eval html {os.path.getsize(html)} B; convert to "
        ".json read back the same poses and landmarks exactly; K2 launches "
        f"{res['launches']['seg_sum']}, K3 {res['launches']['smatvec']}")
    return res


def phase_stellar(kernel_mods, run, n_views, matches="matches.f.bin"):
    """sfm -s STELLAR -> color -> eval on the filter f matches; the sfm
    phase's gates but the polish (STELLAR has none), K2 and K3 launched."""
    res = phase_sfm(kernel_mods, run, n_views, engine="STELLAR", matches=matches,
                    recon_name="recon_stellar", tag="[stellar]",
                    need=("seg_sum", "smatvec"), polish_gate=False)
    if res["polish_steps"] != 0:
        fail("[stellar] STELLAR ran an f64 polish; the reference has none")
    log(f"[stellar] {res['pods']} pods; K2 launches {res['launches']['seg_sum']}, K3 "
        f"launches {res['launches']['smatvec']}")
    return res


def cut_run(run, n_views, tag):
    """The run cut to its first n_views views: init on links to their
    images (the run's focal, pinhole), and the filter f matches between
    them as matches.f.cut<n>.bin beside the run's.  Returns (run, matches
    file name)."""
    from openmvg_torch import cli
    from openmvg_torch.io.matches_io import load_matches, save_matches

    work = os.path.join(run["work"], f"cut{n_views}")
    imgdir = os.path.join(work, "images")
    os.makedirs(imgdir)
    for name in sorted(os.listdir(run["imgdir"]))[:n_views]:
        os.symlink(os.path.join(run["imgdir"], name), os.path.join(imgdir, name))
    out = os.path.join(work, "out")
    if cli.main(["init", "-i", imgdir, "-o", out, "-f", str(run["focal"]), "-c", "1"]) != 0:
        fail(f"[cut] init of the cut for {tag} returned non-zero")
    kept = {k: v for k, v in load_matches(os.path.join(run["md"], "matches.f.bin")).items()
            if max(k) < n_views}
    name = f"matches.f.cut{n_views}.bin"
    save_matches(kept, os.path.join(run["md"], name))
    log(f"[{tag}] CUT: the first {n_views} of {len(os.listdir(run['imgdir']))} views, "
        f"{len(kept)} filter f pairs (the realistic scale is 100 views of 1024^2)")
    return dict(run, work=work, sfm=os.path.join(out, "sfm_data.json"), imgdir=imgdir), name


def jpeg_golden():
    """The port's decode of the committed fixtures (tests/torch_data: a
    progressive and a restart-marker file written by PIL) and of its own
    encoding of the progressive one's 257 x 131 pixels, RGB and gray, held
    to the sha256 digests of jpeg_digests.json, which a CPU test holds
    against PIL's decode of the same files."""
    import hashlib

    import numpy as np

    from openmvg_torch.io import image, jpeg

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_data")
    with open(os.path.join(data, "jpeg_digests.json")) as f:
        want = json.load(f)

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    got = {n: sha(jpeg.read_jpeg(os.path.join(data, n))) for n in ("progressive.jpg",
                                                                    "restart.jpg")}
    rgb = jpeg.read_jpeg(os.path.join(data, "progressive.jpg"))
    got["encode_rgb"] = sha(jpeg.decode_jpeg(jpeg.encode_jpeg(rgb)))
    got["encode_gray"] = sha(jpeg.decode_jpeg(jpeg.encode_jpeg(image.rgb_to_gray_u8(rgb))))
    bad = sorted(k for k in want if got.get(k) != want[k])
    if bad:
        fail(f"[jpeg] golden digests differ: {bad}")
    log(f"[jpeg] golden digests equal ({', '.join(sorted(want))}; {rgb.shape[1]} x "
        f"{rgb.shape[0]})")
    return sorted(want)


def phase_jpeg(kernel_mods, run, n_views, size, mhz):
    """The main path on photographs: the pipeline phase's renders
    re-encoded as .jpg through the port's write_image, then init without
    -f (no EXIF: the size, and the focal 1.2 x size), features HIGH,
    pairs CONTIGUOUS 6, matches, filter f, sfm INCREMENTAL, color and eval,
    every kernel's count set to 0 just before and read just after; the
    pipeline's and the sfm phase's gates, K1 and K2 launched, K3 not.
    Then K1 and K2 at this run's own shapes against their plain versions
    (jpeg_shapes): K1 on its matches batch, exact; K2's camera sums and
    generic sums at its final bundle adjustment, within 1e-5 (1 + S); each
    timed beside its bound (CUDA events; no profiler session)."""
    import numpy as np

    from openmvg_torch.io import image
    from openmvg_torch.ops import seg_sum, two_nn
    from openmvg_torch.io.matches_io import load_matches
    from openmvg_torch.io.sfm_data import load_sfm_data

    work = os.path.join(run["work"], "jpeg")
    jdir = os.path.join(work, "images")
    os.makedirs(jdir)
    enc = dec = 0.0
    diffs = []
    names = sorted(os.listdir(run["imgdir"]))
    for name in names:
        a = image.read_image(os.path.join(run["imgdir"], name))
        path = os.path.join(jdir, os.path.splitext(name)[0] + ".jpg")
        t = time.perf_counter()
        image.write_image(path, a)
        enc += time.perf_counter() - t
        t = time.perf_counter()
        b = image.read_image(path)
        dec += time.perf_counter() - t
        diffs.append(float(np.abs(a.astype(np.int16) - b).mean()))
    enc_ms, dec_ms = 1e3 * enc / len(names), 1e3 * dec / len(names)
    mad = float(np.mean(diffs))
    log(f"[jpeg] {len(names)} views re-encoded as .jpg: encode {enc_ms:.2f} ms, decode "
        f"{dec_ms:.2f} ms an image (host); mean |JPEG - PNG| {mad:.3f} gray levels")
    out = os.path.join(work, "out")
    md = os.path.join(work, "matches")
    sfm = os.path.join(out, "sfm_data.json")
    recon = os.path.join(work, "recon")
    scene_path = os.path.join(recon, "sfm_data.bin")
    stages = [
        ("init", ["init", "-i", jdir, "-o", out, "-c", "1"]),
        ("features", ["features", "-i", sfm, "-o", md, "-p", "HIGH"]),
        ("pairs", ["pairs", "-i", sfm, "-m", "CONTIGUOUS", "-c", "6",
                   "-o", os.path.join(md, "pairs.txt")]),
        ("matches", ["matches", "-i", sfm, "-o", os.path.join(md, "matches.putative.bin"),
                     "-p", os.path.join(md, "pairs.txt"), "-r", "0.8"]),
        ("filter", ["filter", "-i", sfm, "-m", os.path.join(md, "matches.putative.bin"),
                    "-o", os.path.join(md, "matches.f.bin"), "-g", "f"]),
        ("sfm", ["sfm", "-i", sfm, "-m", md, "-M", os.path.join(md, "matches.f.bin"),
                 "-o", recon, "-s", "INCREMENTAL", "--output_format", "bin"]),
        ("color", ["color", "-i", scene_path, "-o", os.path.join(recon, "colorized.ply")]),
        ("eval", ["eval", "-i", scene_path, "-g", run["gtdir"]]),
    ]
    secs, printed, launches = run_stages(kernel_mods, stages)
    log("[jpeg] stage seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
        + f"; the PNG run's features {run['secs']['features']:.2f} s in the same call")
    focal = float(load_sfm_data(sfm).cameras.params[0][0])
    if abs(focal - 1.2 * size) > 1e-9:
        fail(f"[jpeg] init without -f gave the focal {focal}, not 1.2 x {size}")
    if launches["two_nn"] <= 0 or launches["smatvec"] <= 0:
        fail(f"[jpeg] launches {launches}: K1 and K3 must launch")
    Rs, Cs, K, _ = run["gt"]
    kept = load_matches(os.path.join(md, "matches.f.bin"))
    n_pairs = sum(min(6, n_views - 1 - i) for i in range(n_views))
    n_ok, n_all = epipolar_check(md, kept, Rs, Cs, K, size)
    share = n_ok / max(n_all, 1)
    log(f"[jpeg] init focal {focal} (1.2 x {size}, no EXIF); pairs kept {len(kept)}/{n_pairs}; "
        f"{100 * share:.2f}% of {n_all} filtered matches within 4 px of the ground-truth "
        "epipolar line")
    if share < 0.95 or len(kept) < 0.9 * n_pairs:
        fail(f"[jpeg] {100 * share:.2f}% within 4 px, {len(kept)} of {n_pairs} pairs kept")
    stats = json.loads(printed["eval"].getvalue())
    scene, polish_steps, rounds, _ = check_reconstruction(
        "[jpeg]", scene_path, os.path.join(recon, "colorized.ply"), stats, n_views,
        ("two_nn", "seg_sum"), launches, printed["sfm"].getvalue())
    shapes = {"k1_matches_batch": phase_measure(two_nn, k1_batch_inputs(md, n_views), "cuda",
                                                mhz, tag="[jpeg]", profiled=False),
              "k2_final_ba": phase_measure_k2(seg_sum, final_problem(scene), tag="[jpeg]",
                                              profiled=False)}
    return dict(secs=secs, launches=launches, shapes=shapes, encode_ms=enc_ms, decode_ms=dec_ms,
                mean_abs_diff=mad, focal=focal, pairs_kept=[len(kept), n_pairs],
                epipolar_share=share, polish_steps=polish_steps, rounds=rounds,
                eval={k: v for k, v in stats.items() if not isinstance(v, dict)},
                png_features_s=run["secs"]["features"], golden=jpeg_golden())


def native_match_check(two_nn, headline, k1_ms):
    """The reference's CPU 2-NN baseline (openmvg_torch.native, AVX2 +
    OpenMP) on K1's headline 16 pairs of 4096 x 4096 x 128, with the first
    1,024 A rows of each pair planted between a B row and a random row
    (A = round((1 - t) B + t R), t uniform in [0, 1], B rows from the
    unplanted half) so that the ratio test keeps rows and squared ratios
    fall on both sides of 0.8^2 and of 0.8.  K1 runs on the planted copy
    (a comparison launch).  On every row whose nearest neighbour is unique
    the baseline's index equals K1's, and its keep flags equal the
    reference's rule on K1's squared distances, d1 < 0.8^2 d2
    (openmvg_tpu/native/native.cpp:350-354), with rows kept and rows whose
    d1 / d2 lies in [0.64, 0.8), which d1 < 0.8 d2 would keep."""
    import numpy as np
    import torch

    from openmvg_torch import native

    descs, pairs, _ = headline
    D, P = descs.cpu().numpy().copy(), pairs.cpu().numpy()
    rng = np.random.default_rng(11)
    N = D.shape[1]
    n_plant = N // 4
    for i, j in P:  # B rows come from [N/2, N), which no planting touches
        src = rng.integers(N // 2, N, n_plant)
        t = rng.uniform(0.0, 1.0, (n_plant, 1))
        mix = (1 - t) * D[j, src] + t * rng.integers(0, 256, (n_plant, D.shape[2]))
        D[i, :n_plant] = np.clip(np.rint(mix), 0, 255)
    dd = torch.as_tensor(D, device=descs.device)
    counts = torch.full((D.shape[0],), N, dtype=torch.int32, device=descs.device)
    d1, d2, idx = (x.cpu().numpy() for x in two_nn.two_nn_batch(dd, counts, pairs))
    d1, d2 = d1.astype(np.float64), d2.astype(np.float64)
    t = time.perf_counter()
    res = [native.bench_match_2nn(D[i], D[j], 0.8) for i, j in P]
    ms = 1e3 * (time.perf_counter() - t)
    unique = d1 < d2
    keep = d1 < (0.8 * 0.8) * d2
    between = (d1 >= (0.8 * 0.8) * d2) & (d1 < 0.8 * d2)
    if not keep.any() or not between.any():
        fail(f"[native] the planted rows give {int(keep.sum())} kept and {int(between.sum())} "
             "between 0.64 and 0.8: the keep check would not separate the rules")
    for p, (ci, ck) in enumerate(res):
        if not np.array_equal(ci[unique[p]], idx[p][unique[p]]):
            fail(f"[native] bench_match_2nn: pair {p}'s indices differ from K1's")
        if not np.array_equal(ck.astype(bool), keep[p]):
            fail(f"[native] bench_match_2nn: pair {p}'s keep flags differ from K1's")
    log(f"[native] CPU baseline bench_match_2nn (AVX2 + OpenMP, {os.cpu_count()} host cores) on "
        f"the {len(P)} pairs of {N} x {N} x {D.shape[2]} ({n_plant} planted A rows a pair): "
        f"{ms:.1f} ms against K1's {k1_ms:.3f} ms; indices equal on {int(unique.sum())} unique "
        f"rows of {unique.size}, keep flags equal ({int(keep.sum())} kept, "
        f"{int(between.sum())} with d1/d2 in [0.64, 0.8))")
    return dict(ms=ms, unique_rows=int(unique.sum()), rows=int(unique.size),
                kept=int(keep.sum()), between_064_08=int(between.sum()), planted_rows=n_plant)


def native_ba_check(scene):
    """The reference's CPU LM baseline (openmvg_torch.native.
    bench_ba_lm_step, -march=native) at the final INCREMENTAL scene's
    problem, built as the f64 polish builds it, against the polish's own
    step (sfm/polish.py::ba_lm_step_k) with the same fixed intrinsics: the
    costs before and after within 1e-10 relative."""
    import numpy as np

    from openmvg_torch import native
    from openmvg_torch.sfm import polish
    from openmvg_torch.utils import hostmath

    info = scene.obs_arrays_for_ba()
    pose_ids, point_ids = np.unique(info["pose_id"]), np.unique(info["landmark_id"])
    obs_pose = np.searchsorted(pose_ids, info["pose_id"]).astype(np.int32)
    obs_point = np.searchsorted(point_ids, info["landmark_id"]).astype(np.int32)
    obs_x = np.ascontiguousarray(info["x"], np.float64)
    R = scene.pose_R[pose_ids]
    rotvec = np.ascontiguousarray(hostmath.logmap_np(R), np.float64)
    t = np.ascontiguousarray(-np.einsum("nij,nj->ni", R, scene.pose_C[pose_ids]), np.float64)
    X = np.ascontiguousarray(scene.X[point_ids], np.float64)
    kp = np.asarray(scene.cameras.params, np.float64)[0, 0:3].copy()
    runs = {}
    for name in ("baseline", "polish"):
        arrs = [a.copy() for a in (rotvec, t, X)]
        t0 = time.perf_counter()
        if name == "baseline":
            out = native.bench_ba_lm_step(obs_pose, obs_point, obs_x, *arrs, *kp)
        else:
            out = polish.ba_lm_step_k(obs_pose, obs_point, obs_x, *arrs, kp.copy(),
                                      refine_k=False)
        runs[name] = (1e3 * (time.perf_counter() - t0), *out)
    (ms, ok, c0, c1), (pms, pok, p0, p1) = runs["baseline"], runs["polish"]
    rel = max(abs(c0 - p0) / abs(p0), abs(c1 - p1) / abs(p1))
    log(f"[native] CPU baseline bench_ba_lm_step at the final INCREMENTAL problem (O "
        f"{len(obs_pose)}, P {len(pose_ids)}, L {len(point_ids)}): {ms:.1f} ms (the polish's "
        f"step {pms:.1f} ms); cost {c0:.9g} -> {c1:.9g} (accepted {ok}), polish {p0:.9g} -> "
        f"{p1:.9g} (accepted {pok}), {rel:.3g} relative")
    if not rel <= 1e-10 or ok != pok:
        fail(f"[native] bench_ba_lm_step's cost differs from the polish's by {rel:.3g}")
    return dict(ms=ms, polish_ms=pms, O=len(obs_pose), P=len(pose_ids), L=len(point_ids),
                cost=[c0, c1], rel=rel)


def _roty(theta):
    import numpy as np

    c, s_ = math.cos(theta), math.sin(theta)
    return np.array([[c, 0.0, s_], [0.0, 1.0, 0.0], [-s_, 0.0, c]])


def model_sets(model, n_pairs, n_true, n_out, seed, dev="cuda"):
    """tests/test_geometric_filter_models.py's correspondence sets, scaled
    up and made on the card: n_pairs two-view pairs (views 2p, 2p + 1) of
    n_true true correspondences and n_out uniform outliers, each pair with
    its own motion.  "h": a slanted plane under upright motion; "u": a
    point cloud under upright motion (rotation about y, translation in the
    xz plane); "o": orthographic projection.  Returns (scene, features,
    matches) for geometric_filter."""
    import numpy as np
    import torch

    from openmvg_torch.models import cameras as cm
    from openmvg_torch.sfm.scene import Scene

    f, wh = 800.0, 1000
    g = torch.Generator(device=dev).manual_seed(seed)
    n = n_true + n_out

    def uni(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev,
                                           dtype=torch.float64)

    rng = np.random.default_rng(seed)
    if model == "o":
        X = uni(-0.3, 0.3, n_pairs, n_true, 3)
        R = np.stack([_roty(math.radians(rng.uniform(5, 15))) @ np.array(
            [[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1.0]])
            for a in rng.uniform(-0.15, 0.15, n_pairs)])
        t = np.c_[rng.uniform(-0.05, 0.05, (n_pairs, 2)), np.zeros(n_pairs)]
        R_t, t_t = torch.as_tensor(R, device=dev), torch.as_tensor(t, device=dev)
        xa = X[..., :2] * f + wh / 2
        xb = (torch.einsum("pij,pnj->pni", R_t, X) + t_t[:, None])[..., :2] * f + wh / 2
        lo, hi = 300, 700
    else:
        X = uni(-1, 1, n_pairs, n_true, 3)
        X[..., 2] = (0.2 * X[..., 0] if model == "h" else X[..., 2]) + 5.0
        R = np.stack([_roty(math.radians(a)) for a in rng.uniform(4, 12, n_pairs)])
        C = np.c_[rng.uniform(0.3, 0.8, n_pairs), np.zeros(n_pairs), rng.uniform(-0.2, 0.2,
                                                                                  n_pairs)]
        R_t, C_t = torch.as_tensor(R, device=dev), torch.as_tensor(C, device=dev)
        Xc = torch.einsum("pij,pnj->pni", R_t, X - C_t[:, None])
        xa = X[..., :2] / X[..., 2:] * f + wh / 2
        xb = Xc[..., :2] / Xc[..., 2:] * f + wh / 2
        lo, hi = 100, 900
    xa = torch.cat([xa, uni(lo, hi, n_pairs, n_out, 2)], 1).cpu().numpy()
    xb = torch.cat([xb, uni(lo, hi, n_pairs, n_out, 2)], 1).cpu().numpy()
    V = 2 * n_pairs
    sc = Scene()
    sc.view_filename = [f"v{i}.png" for i in range(V)]
    sc.view_intrinsic = np.zeros(V, np.int32)
    sc.view_pose = np.arange(V, dtype=np.int32)
    sc.view_wh = np.tile([[wh, wh]], (V, 1)).astype(np.int32)
    sc.cameras = cm.make_pinhole(wh, wh, f, wh / 2, wh / 2)
    sc.pose_valid = np.zeros(V, bool)
    sc.pose_R = np.tile(np.eye(3), (V, 1, 1))
    sc.pose_C = np.zeros((V, 3))
    feats = [x for p in range(n_pairs) for x in (xa[p], xb[p])]
    m = np.stack([np.arange(n)] * 2, 1)
    return sc, feats, {(2 * p, 2 * p + 1): m for p in range(n_pairs)}


def k1_at_known_poses(two_nn, scene_path, md, dev):
    """K1 on the pair list and descriptor stack that known-poses builds
    (every posed pair of the scene, in launches of at most MAX_PAIRS)
    against its plain version: d1, d2 and idx1 equal.  Returns the shape,
    the largest |error|, the kernel's, the plain version's and the library
    call's milliseconds and the bound.  The library call is cdist + topk in
    chunks of pairs whose distances fit 4 GiB (k1_library_chunked): over
    every pair at once it would hold P x Nmax^2 float32 distances (251 GB at
    4,950 pairs of 3,562)."""
    import itertools

    import numpy as np
    import torch

    from openmvg_torch import cli
    from openmvg_torch.ops import matching
    from openmvg_torch.sfm.known_poses import posed_views

    scene = cli._load_scene(scene_path)
    _, descs = cli._load_features_for_scene(scene, md)
    pairs = list(itertools.combinations(posed_views(scene), 2))
    stack, counts = matching.descriptor_stack(descs, dev)
    chunks = [torch.as_tensor(np.asarray(pairs[s:s + two_nn.MAX_PAIRS], np.int32),
                              device=dev) for s in range(0, len(pairs), two_nn.MAX_PAIRS)]

    def kernel():
        return [two_nn.two_nn_batch(stack, counts, c) for c in chunks]

    got = kernel()
    torch.cuda.synchronize()
    t = time.perf_counter()
    ref = [two_nn.two_nn_batch_plain(stack, counts, c) for c in chunks]
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t)
    err = 0.0
    for g, r in zip(got, ref):
        for x, y, what in zip(g, r, ("d1", "d2", "idx1")):
            if not torch.equal(x, y):
                fail(f"[matchers] K1 at known-poses' shape: {what} differs from the plain "
                     f"version in {(x != y).sum().item()} entries")
        err = max(err, (g[0] - r[0]).abs().max().item(), (g[1] - r[1]).abs().max().item())
    del got, ref
    ms = cuda_ms(kernel, 3, 1)
    all_pairs = torch.cat(chunks)
    lib_ms = cuda_ms(lambda: k1_library_chunked(stack, counts, all_pairs), 1, 1)
    bounds = [two_nn_bound_ms(stack, counts, c, c.shape[0] * stack.shape[1]) for c in chunks]
    bound = sum(b for b, _ in bounds)
    log(f"[matchers] K1 at known-poses' shape ({len(pairs)} pairs in {len(chunks)} launch(es), "
        f"Nmax {stack.shape[1]}, counts {int(counts.min())}..{int(counts.max())}): equal to "
        f"the plain version; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, cdist + topk in "
        f"chunks {lib_ms:.3f} ms, bound {bound:.4f} ms ({bounds[0][1]}); "
        f"{bound / ms * 100:.2f}% of the bound")
    return dict(pairs=len(pairs), launches=len(chunks), nmax=int(stack.shape[1]),
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bounds[0][1], library_ms=lib_ms)


def k2_at_vlad_lloyd(seg_sum, vlad, pooled, centers, dev):
    """K2 as a Lloyd iteration of the VLAD codebook runs it
    (vlad.cluster_sums: every pooled row summed by its centre, two
    64-column calls sharing one plan) against seg_sum_plain in float64,
    within 1e-5 (1 + S), S the sums of |rows|.  Returns the shape, the
    largest |error|, the times (the plan's build included, as the Lloyd
    loop runs it) and the bound."""
    import numpy as np
    import torch

    X = torch.as_tensor(np.asarray(pooled, np.float32), device=dev)
    c = torch.as_tensor(np.asarray(centers, np.float32), device=dev)
    assign = vlad.nearest_center(X, c)
    k = c.shape[0]
    got = vlad.cluster_sums(X, assign, k)
    err = seg_sum_check(seg_sum, got, X, assign, k, 1e-5)
    if err is None:
        fail(f"[matchers] K2 at the VLAD Lloyd sums' shape ({X.shape[0]} rows x "
             f"{X.shape[1]}, {k} centres) differs from seg_sum_plain beyond 1e-5 (1 + S)")
    ms = cuda_ms(lambda: vlad.cluster_sums(X, assign, k), 20)
    plain_ms = cuda_ms(lambda: seg_sum.seg_sum_plain(X, assign, k), 20)
    lib_ms = cuda_ms(lambda: library_seg_sum(X, assign, k), 20)
    bound, by = seg_sum_bound_ms(X.shape[0], X.shape[1], k, 4)
    log(f"[matchers] K2 at the VLAD Lloyd sums' shape ({X.shape[0]} rows x {X.shape[1]}, {k} "
        f"centres): max |err| {err:.3g} against float64; kernel {ms:.4f} ms (two 64-column "
        f"calls and their plan), plain {plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({by}); {bound / ms * 100:.2f}% of the bound")
    return dict(O=int(X.shape[0]), D=int(X.shape[1]), num=int(k), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by)


def phase_matchers(kernel_mods, run, srun, n_views, dev="cuda", n_synth=256):
    """The matching and filtering layer's other paths on the pipeline's run
    directory, each with every kernel's count set to 0 just before and read
    just after: cascade matching then filter f; filter -g a; filter -g f -r
    (guided matching on K1); the models h, u and o on synthetic sets of the
    reference test's kind (256 pairs of 400 + 100) and, ungated, on the
    sphere's putative matches; known-poses on the INCREMENTAL scene (K1,
    then held against its plain version at the stage's shape); vlad -k 64
    -t 10 (K2, then the Lloyd sums held against their plain version);
    kvld-filter on the first 10 putative pairs.  Returns each step's
    seconds, launches and readings."""
    import numpy as np
    import torch

    from openmvg_torch.io.features_io import load_descs, load_feats
    from openmvg_torch.io.image import read_image
    from openmvg_torch.io.matches_io import load_matches, save_matches
    from openmvg_torch.io.sfm_data import load_sfm_data
    from openmvg_torch.ops import kvld, seg_sum, two_nn, vlad
    from openmvg_torch.sfm.geometric_filter import geometric_filter
    from openmvg_torch.sfm.scene import rmse

    md, sfm = run["md"], run["sfm"]
    Rs, Cs, K, size = run["gt"]
    n_pairs = len(run["pairs"])
    pairs_txt = os.path.join(md, "pairs.txt")
    put_path = os.path.join(md, "matches.putative.bin")
    putative = load_matches(put_path)
    plain_f = load_matches(os.path.join(md, "matches.f.bin"))
    out = {}

    def step(name, stages):
        secs, printed, launches = run_stages(kernel_mods, stages)
        out[name] = dict(s=sum(secs.values()), launches=launches)
        return out[name], printed

    def gate_filtered(tag, path, rec):
        kept = load_matches(path)
        n_ok, n_all = epipolar_check(md, kept, Rs, Cs, K, size)
        share = n_ok / max(n_all, 1)
        rec.update(pairs_kept=len(kept), matches=n_all, epipolar_share=share)
        log(f"[matchers] {tag}: {len(kept)}/{n_pairs} pairs kept, {n_all} matches, "
            f"{100 * share:.2f}% within 4 px of the ground-truth epipolar line, "
            f"{rec['s']:.2f} s, launches {rec['launches']}")
        if share < 0.95:
            fail(f"[matchers] {tag}: only {100 * share:.2f}% within 4 px")
        if len(kept) < 0.9 * n_pairs:
            fail(f"[matchers] {tag}: only {len(kept)} of {n_pairs} pairs kept")
        return kept

    # 1. cascade hashing, then filter f on its matches
    casc = os.path.join(md, "matches.cascade.bin")
    rec, _ = step("cascade", [
        ("matches", ["matches", "-i", sfm, "-o", casc, "-p", pairs_txt, "-n",
                     "CASCADEHASHINGL2"]),
        ("filter", ["filter", "-i", sfm, "-m", casc, "-o", os.path.join(md, "matches.cf.bin"),
                    "-g", "f"])])
    cm_ = load_matches(casc)
    bf = {(p, tuple(r)) for p, m in putative.items() for r in m}
    ch = {(p, tuple(r)) for p, m in cm_.items() for r in m}
    rec["recall"] = len(bf & ch) / max(len(bf), 1)
    log(f"[matchers] cascade: {len(ch)} putative matches, recall {rec['recall']:.4f} "
        "against BRUTEFORCEL2")
    if rec["recall"] < 0.90:
        fail(f"[matchers] cascade recall {rec['recall']:.4f} below 0.90")
    gate_filtered("cascade + filter -g f", os.path.join(md, "matches.cf.bin"), rec)

    # 2. filter -g a
    pa = os.path.join(md, "matches.a.bin")
    rec, _ = step("filter_a", [("filter", ["filter", "-i", sfm, "-m", put_path, "-o", pa,
                                           "-g", "a"])])
    gate_filtered("filter -g a", pa, rec)

    # 3. filter -g f -r (guided matching, one K1 launch for the kept pairs)
    pr = os.path.join(md, "matches.fr.bin")
    rec, _ = step("filter_f_r", [("filter", ["filter", "-i", sfm, "-m", put_path, "-o", pr,
                                             "-g", "f", "-r"])])
    kept = gate_filtered("filter -g f -r", pr, rec)
    n_r, n_f = sum(map(len, kept.values())), sum(map(len, plain_f.values()))
    rec["plain_f_matches"] = n_f
    log(f"[matchers] filter -g f -r kept {n_r} matches against {n_f} for -g f; K1 launches "
        f"{rec['launches']['two_nn']}")
    if n_r < n_f:
        fail(f"[matchers] guided matching kept {n_r} matches, fewer than -g f's {n_f}")
    if rec["launches"]["two_nn"] < 1:
        fail("[matchers] guided matching did not launch K1")

    # 4. models h, u, o: synthetic sets (gated), then the sphere (not gated)
    for model, true_share, out_share in (("h", 0.85, 0.1), ("u", 0.85, 0.1),
                                         ("o", 0.8, 0.15)):
        sc, feats, mset = model_sets(model, n_synth, 400, 100, seed=ord(model), dev=dev)
        for m_ in kernel_mods:
            m_.LAUNCHES = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = geometric_filter(sc, feats, mset, model=model, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        worst_true, worst_false = 400, 0
        for p in mset:
            if p not in res:
                fail(f"[matchers] model {model} rejected synthetic pair {p}")
            k_ = res[p][:, 0]
            worst_true = min(worst_true, int((k_ < 400).sum()))
            worst_false = max(worst_false, int((k_ >= 400).sum()))
        log(f"[matchers] model {model}: {n_synth} synthetic pairs of 400 + 100 in {dt:.2f} s; "
            f"every pair kept, the fewest true correspondences {worst_true}/400, the most "
            f"outliers {worst_false}/100")
        if worst_true <= true_share * 400 or worst_false > out_share * 100 + 2:
            fail(f"[matchers] model {model}: a pair kept {worst_true}/400 true and "
                 f"{worst_false}/100 outliers")
        pm = os.path.join(md, f"matches.{model}.bin")
        rec, _ = step(f"filter_{model}", [("filter", ["filter", "-i", sfm, "-m", put_path,
                                                      "-o", pm, "-g", model])])
        kept = load_matches(pm)
        n_ok, n_all = epipolar_check(md, kept, Rs, Cs, K, size)
        rec.update(synthetic_s=dt, synthetic_min_true=worst_true,
                   synthetic_max_outliers=worst_false, pairs_kept=len(kept), matches=n_all,
                   epipolar_share=n_ok / max(n_all, 1))
        log(f"[matchers] filter -g {model} on the sphere (not gated): {len(kept)}/{n_pairs} "
            f"pairs, {n_all} matches ({100 * n_ok / max(n_all, 1):.2f}% within 4 px), "
            f"{rec['s']:.2f} s")

    # 5. known-poses on the INCREMENTAL scene
    inc = os.path.join(srun["recon"], "sfm_data.json")
    kp = os.path.join(run["work"], "known_poses.json")
    rec, printed = step("known_poses", [("known-poses", ["known-poses", "-i", inc, "-m", md,
                                                         "-o", kp])])
    scene_kp = load_sfm_data(kp)
    rec.update(landmarks=scene_kp.n_landmarks, incremental_landmarks=srun["scene"].n_landmarks,
               rmse_px=rmse(scene_kp))
    log(f"[matchers] known-poses: {scene_kp.n_landmarks} landmarks (INCREMENTAL "
        f"{srun['scene'].n_landmarks}), rmse {rec['rmse_px']:.4f} px, {rec['s']:.2f} s, "
        f"K1 launches {rec['launches']['two_nn']}")
    if scene_kp.n_landmarks < 0.5 * srun["scene"].n_landmarks:
        fail("[matchers] known-poses found fewer than half the INCREMENTAL landmarks")
    if not rec["rmse_px"] < 1.0:
        fail(f"[matchers] known-poses rmse {rec['rmse_px']:.4f} px")
    if rec["launches"]["two_nn"] < 1:
        fail("[matchers] known-poses did not launch K1")
    rec["k1_at_shape"] = k1_at_known_poses(two_nn, inc, md, dev)

    # 6. vlad -k 64 -t 10, and its embeddings against their plain float64 version
    vp = os.path.join(run["work"], "vlad_pairs.txt")
    rec, _ = step("vlad", [("vlad", ["vlad", "-i", sfm, "-m", md, "-o", vp, "-k", "64",
                                     "-t", "10"])])
    from openmvg_torch import cli

    vpairs = cli.load_pairs_file(vp)
    seen = {v for p in vpairs for v in p}
    near = sum(1 for i, j in vpairs if min(abs(i - j), n_views - abs(i - j)) <= 6)
    descs = [load_descs(os.path.join(md, f"img_{v:02d}.desc")) for v in range(n_views)]
    pooled = np.concatenate([d[:500] for d in descs if len(d)])
    centers = vlad.build_codebook(torch.Generator().manual_seed(0), pooled, k=64, device=dev)
    c_t = torch.as_tensor(centers, device=dev)
    desc = torch.as_tensor(np.concatenate(descs).astype(np.float32), device=dev)
    view = torch.as_tensor(np.repeat(np.arange(n_views), [len(d) for d in descs]), device=dev)
    assign = vlad.nearest_center(desc, c_t)
    card = vlad.vlad_from_assign(desc, c_t, assign, view, n_views)
    plain = vlad.vlad_from_assign(desc.double().cpu(), c_t.double().cpu(), assign.cpu(),
                                  view.cpu(), n_views)
    err = float((card.double().cpu() - plain).abs().max())
    rec.update(pairs=len(vpairs), views_in_pairs=len(seen), near_share=near / max(len(vpairs), 1),
               embedding_max_abs_err=err)
    log(f"[matchers] vlad: {len(vpairs)} pairs, {len(seen)}/{n_views} views in a pair, "
        f"{100 * rec['near_share']:.1f}% of the pairs within 6 views on the ring; "
        f"embeddings on the card vs plain float64 max |err| {err:.3g}; {rec['s']:.2f} s, "
        f"K2 launches {rec['launches']['seg_sum']}")
    if err > 1e-5:
        fail(f"[matchers] vlad embeddings differ from the plain float64 version by {err:.3g}")
    if len(seen) < n_views:
        fail(f"[matchers] vlad left {n_views - len(seen)} views out of every pair")
    if rec["launches"]["seg_sum"] < 1:
        fail("[matchers] vlad did not launch K2")
    rec["k2_lloyd_at_shape"] = k2_at_vlad_lloyd(seg_sum, vlad, pooled, centers, dev)

    # 7. kvld-filter on the first 10 putative pairs (a cut of the 579)
    first = sorted(putative)[:10]
    sub, kv = os.path.join(md, "matches.sub10.bin"), os.path.join(md, "matches.kvld.bin")
    save_matches({p: putative[p] for p in first}, sub)
    log(f"[matchers] kvld-filter CUT: the first {len(first)} of {len(putative)} putative "
        "pairs")
    rec, _ = step("kvld", [("kvld-filter", ["kvld-filter", "-i", sfm, "-m", sub, "-o", kv])])
    kept = load_matches(kv)
    n_ok, n_all = epipolar_check(md, kept, Rs, Cs, K, size)
    i, j = first[0]
    m0 = putative[(i, j)]
    fi, fj = (load_feats(os.path.join(md, f"img_{v:02d}.feat")) for v in (i, j))
    scene = load_sfm_data(sfm)
    imgs = [np.asarray(read_image(os.path.join(scene.root_path, scene.view_filename[v]),
                                  grayscale=True), np.float64) * 255.0 for v in (i, j)]
    rng = np.random.default_rng(0)
    a, b = rng.integers(0, len(m0), (2, 2048))
    diffs = []
    for d in (dev, "cpu"):
        p1, p2 = (kvld.pyramid_on(kvld.build_image_scale(im), d) for im in imgs)

        def pts(f, side, idx):
            return torch.as_tensor(f[m0[idx, side], :2].astype(np.float64), device=d)

        diffs.append(kvld.vld_pair_diff(p1, p2, pts(fi, 0, a), pts(fi, 0, b), pts(fj, 1, a),
                                        pts(fj, 1, b)).cpu())
    verr = float((diffs[0] - diffs[1]).abs().max())
    rec.update(pairs=len(first), pairs_kept=len(kept), matches=n_all,
               epipolar_share=n_ok / max(n_all, 1), vld_max_abs_err=verr)
    log(f"[matchers] kvld-filter: {len(kept)}/{len(first)} pairs keep matches, {n_all} "
        f"matches, {100 * rec['epipolar_share']:.2f}% within 4 px; pair {(i, j)}: 2048 VLD "
        f"differences on the card vs the CPU float64 version max |err| {verr:.3g}; "
        f"{rec['s']:.2f} s")
    if len(kept) < len(first):
        fail(f"[matchers] kvld-filter left {len(first) - len(kept)} pairs without a match")
    if rec["epipolar_share"] < 0.95:
        fail(f"[matchers] kvld-filter: only {100 * rec['epipolar_share']:.2f}% within 4 px")
    if verr > 1e-9:
        fail(f"[matchers] VLD differences on the card differ from the CPU by {verr:.3g}")
    out["launches_two_nn"] = sum(r["launches"]["two_nn"] for r in out.values())
    out["launches_seg_sum_vlad"] = out["vlad"]["launches"]["seg_sum"]
    return out


class StageClock(Tee):
    """A Tee that notes the time each `pipeline` stage starts (its
    "=== openmvg_torch <stage>" line)."""

    def __init__(self, out):
        super().__init__(out)
        self.marks = []

    def write(self, text):
        if text.startswith("=== openmvg_torch "):
            import torch

            torch.cuda.synchronize()
            self.marks.append((text.split()[2], time.perf_counter()))
        return super().write(text)


def phase_camera3(kernel_mods, n_views, size, work):
    """The one-command main path with every default but the focal:
    `pipeline -i images -o run -f <focal>` (camera model 3, NORMAL,
    EXHAUSTIVE pairs, filter f, INCREMENTAL), then eval; every kernel's
    count set to 0 just before the pipeline and read just after."""
    import contextlib

    import numpy as np
    import torch

    from openmvg_torch import cli
    from openmvg_torch.utils.logging import stage_times
    from openmvg_torch.utils.synthetic import render_textured_sphere_dataset

    focal = 1.2 * size
    imgdir, gtdir, _, _, _ = render_textured_sphere_dataset(
        work, n_views=n_views, size=size, focal=focal, seed=1,
        arc_step=min(2 * math.pi / n_views, 0.063), device="cuda")
    out = os.path.join(work, "run")
    recon = os.path.join(out, "reconstruction_sequential")
    clock = StageClock(sys.stdout)
    for m in kernel_mods:        # every kernel's count, just before the path
        m.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(clock):
        rc = cli.main(["pipeline", "-i", imgdir, "-o", out, "-f", str(focal)])
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in kernel_mods}  # just after
    if rc != 0:
        fail(f"[camera3] pipeline returned {rc}")
    marks = clock.marks + [("end", t_end)]
    secs = {a[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    engine = dict(stage_times)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    scene_path = os.path.join(recon, "sfm_data.json")
    secs_eval, printed, _ = run_stages([], [("eval", ["eval", "-i", scene_path, "-g", gtdir])])
    secs["eval"] = secs_eval["eval"]
    stats = json.loads(printed["eval"].getvalue())
    log(f"[camera3] stage seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
        + f"; pipeline {t_end - t0:.2f}; peak device memory {peak_gb:.2f} GiB")
    log("[camera3] engine stage seconds: " + ", ".join(f"{k} {v:.3f}"
                                                     for k, v in engine.items()))
    n_pairs = n_views * (n_views - 1) // 2
    scene, polish_steps, rounds, _ = check_reconstruction(
        "[camera3]", scene_path, os.path.join(recon, "colorized.ply"), stats, n_views,
        ("two_nn", "seg_sum"), launches, clock.getvalue(), polish_gate=False,
        min_poses=n_views - 1)
    kinds = sorted(set(int(k) for k in scene.cameras.kind))
    k123 = np.asarray(scene.cameras.params)[:, 3:6]
    if kinds != [3]:
        fail(f"[camera3] intrinsic kinds {kinds}, not PINHOLE_RADIAL_K3 (3)")
    log(f"[camera3] {n_pairs} exhaustive pairs; intrinsic PINHOLE_RADIAL_K3, k1..k3 "
        f"{k123.tolist()} (rendered without distortion); {polish_steps} polish steps "
        "(not gated: the polish takes one shared PINHOLE only)")
    return dict(secs=secs, launches=launches, engine=engine, stats=stats,
                polish_steps=polish_steps, rounds=rounds, k123=k123.tolist(),
                pipeline_s=t_end - t0, peak_device_gib=peak_gb, n_pairs=n_pairs)


def warp_pair_h(size, angle_deg=12.0, scale=1.15):
    """The homography of the reference's warp test (tests/test_sift_quality.py
    _warp_pair): a rotation by angle_deg and a scale about the centre,
    mapping original pixels to warped pixels."""
    import numpy as np

    c = size / 2.0
    a = math.radians(angle_deg)
    R = np.array([[math.cos(a), -math.sin(a)], [math.sin(a), math.cos(a)]]) * scale
    H = np.eye(3)
    H[:2, :2] = R
    H[:2, 2] = c - R @ [c, c]
    return H


def popcount_hamming(a, b):
    """Plain Hamming distances of packed descriptors a (N, B), b (M, B)
    uint8 by an integer popcount table, byte by byte: (N, M) int32."""
    import torch

    lut = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32,
                       device=a.device)
    ham = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32, device=a.device)
    for k in range(a.shape[1]):
        ham += lut[(a[:, None, k] ^ b[None, :, k]).long()]
    return ham


def mldb_batch_check(stack, counts, pairs_np, res, ratio=0.8):
    """One batch of the MLDB loop against a plain popcount 2-NN, pair by
    pair: the sign-code product equals the popcount at every distance, and
    on the valid rows the batch's distance, match (first minimum) and mask
    (ratio d1 < 0.8 d2, then the best row per right index, lowest row on
    ties) are equal.  Returns the pair count; fails on any difference."""
    import numpy as np
    import torch

    from openmvg_torch.ops import matching

    bits = stack.shape[-1] * 8
    for p, (i, j) in enumerate(pairs_np.tolist()):
        a, b = stack[i, :counts[i]], stack[j, :counts[j]]
        ham = popcount_hamming(a, b)
        prod = (bits - matching._unpack_bits_pm1(a) @ matching._unpack_bits_pm1(b).T) * 0.5
        if not torch.equal(prod, ham.to(prod.dtype)):
            fail(f"[describers] AKAZE_MLDB pair {(i, j)}: the Hamming product differs from "
                 f"the popcount by {int((prod - ham).abs().max())}")
        idx1 = torch.argmin(ham, 1)
        d1 = ham.gather(1, idx1[:, None])[:, 0].to(torch.float32)
        d2 = ham.scatter(1, idx1[:, None], bits + 1).min(1).values.to(torch.float32)
        keep = (d1 < ratio * d2).cpu().numpy()     # in float32, as the matcher
        d1, idx1 = d1.cpu().numpy(), idx1.cpu().numpy()
        seen = np.zeros(b.shape[0], bool)
        mask = np.zeros(len(d1), bool)
        for r in np.lexsort((np.arange(len(d1)), d1)):
            if keep[r] and not seen[idx1[r]]:
                seen[idx1[r]] = mask[r] = True
        n = len(d1)
        got = (res.dist[p, :n].cpu().numpy(), res.idx_b[p, :n].cpu().numpy(),
               res.mask[p, :n].cpu().numpy())
        if not (np.array_equal(got[0], d1) and np.array_equal(got[1], idx1)
                and np.array_equal(got[2], mask)):
            fail(f"[describers] AKAZE_MLDB pair {(i, j)} of the batch: distances, matches or "
                 "masks differ from the plain popcount 2-NN")
        if res.mask[p, n:].any():
            fail(f"[describers] AKAZE_MLDB pair {(i, j)}: a padded row is marked as a match")
    return len(pairs_np)


def k1_at_akaze_float(two_nn, stack, counts, pairs):
    """K1 on AKAZE_FLOAT's (V, Nmax, 64) float32 stack and the pair list in
    one launch, against two_nn_batch_plain: d1 and d2 within 1e-4 (1 + |d|),
    idx1 equal away from near-ties; times (events), the bound and the cdist
    + topk yardstick (16 pairs a call).  Its device time is taken by
    phase_measure, in the same profiler session as the matches batch's."""
    import torch

    P, nmax = pairs.shape[0], stack.shape[1]
    got = two_nn.two_nn_batch(stack, counts, pairs)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ref = two_nn.two_nn_batch_plain(stack, counts, pairs)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t)
    valid = torch.arange(nmax, device=stack.device)[None, :] < counts[pairs[:, 0].long()][:, None]
    err = 0.0
    for x, y, what in zip(got[:2], ref[:2], ("d1", "d2")):
        bad = valid & ((x - y).abs() > 1e-4 * (1 + y.abs()))
        if bad.any():
            fail(f"[describers] K1 at D = 64: {what} outside 1e-4 (1 + |d|) in "
                 f"{int(bad.sum())} entries")
        err = max(err, float(((x - y).abs() * valid).max()))
    near_tie = (ref[1] - ref[0]) <= 2e-4 * (1 + ref[0])
    bad = valid & (got[2] != ref[2]) & ~near_tie
    if bad.any():
        fail(f"[describers] K1 at D = 64: {int(bad.sum())} indices differ away from a tie")
    del got, ref
    ms = cuda_ms(lambda: two_nn.two_nn_batch(stack, counts, pairs), 5, 1)

    def library():
        for s in range(0, P, 16):
            pp = pairs[s:s + 16].long()
            library_two_nn(stack[pp[:, 0]], stack[pp[:, 1]])

    lib_ms = cuda_ms(library, 1, 1)
    bound, by = two_nn_bound_ms(stack, counts, pairs, P * nmax, int8=False)
    log(f"[describers] K1 at AKAZE_FLOAT's shape ({P} pairs, Nmax {nmax}, D 64 float32, counts "
        f"{int(counts.min())}..{int(counts.max())}): max |err| {err:.3g} within 1e-4 (1 + |d|) "
        f"of the plain version; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, cdist+topk "
        f"{lib_ms:.3f} ms, bound {bound:.4f} ms ({by}); {100 * bound / ms:.2f}% of the bound")
    return dict(pairs=P, nmax=int(nmax), dim=64, max_abs_err=err, ms=ms, device_ms=None,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by)


def phase_describers(kernel_mods, run, dev):
    """AKAZE_FLOAT and AKAZE_MLDB through the CLI's features on the run
    directory, matched on the CONTIGUOUS pairs (FLOAT: one K1 launch at
    D = 64; MLDB: batched Hamming products) and filtered with -g f; K1 at
    D = 64 against its plain version; the warp check; FAST, MSER, TBMR,
    LIOP and DIPOLE on one view, card against CPU."""
    import numpy as np
    import torch

    from openmvg_torch import cli
    from openmvg_torch.io.features_io import load_descs, load_feats
    from openmvg_torch.io.image import read_image
    from openmvg_torch.ops import dipole, fast, image_ops, liop, matching, mser, tbmr, two_nn
    from openmvg_torch.sfm.describer import describe_image
    from openmvg_torch.sfm.geometric_filter import geometric_filter

    work, sfm = run["work"], run["sfm"]
    Rs, Cs, K, size = run["gt"]
    n_views = len(run["counts"])
    scene = cli._load_scene(sfm)
    pairs_np = run["pairs"]
    pairs = torch.as_tensor(pairs_np, device=dev)
    n_pairs = len(pairs_np)
    out = {}
    names = {"AKAZE_FLOAT": ("AKAZE_Image_describer_SURF", "AKAZE_Float_Regions", 64, np.float32),
             "AKAZE_MLDB": ("AKAZE_Image_describer_MLDB", "AKAZE_Binary_Regions", 60, np.uint8)}
    for method, (dname, rname, dim, dt) in names.items():
        md = os.path.join(work, "matches_" + method.lower())
        secs, _, _ = run_stages(kernel_mods, [("features", ["features", "-i", sfm, "-o", md,
                                                             "-m", method])])
        with open(os.path.join(md, "image_describer.json")) as f:
            doc = json.load(f)
        if (doc["image_describer"]["polymorphic_name"], doc["regions_type"]["polymorphic_name"]) \
                != (dname, rname):
            fail(f"[describers] {method}: image_describer.json names "
                 f"{doc['image_describer']['polymorphic_name']}, "
                 f"{doc['regions_type']['polymorphic_name']}")
        feats, descs = [], []
        for v in range(n_views):
            stem = os.path.join(md, f"img_{v:02d}")
            feats.append(load_feats(stem + ".feat"))
            descs.append(load_descs(stem + ".desc", dim, dt))
            if os.path.getsize(stem + ".desc") != 8 + len(feats[-1]) * dim * np.dtype(dt).itemsize:
                fail(f"[describers] {method}: {stem}.desc is not {dim} {np.dtype(dt).name} a "
                     "feature")
        n_feat = np.array([len(f) for f in feats])
        stack, counts = matching.descriptor_stack(descs, dev)
        nmax = stack.shape[1]
        col = torch.arange(nmax, device=dev)
        for m in kernel_mods:
            m.LAUNCHES = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        if method == "AKAZE_FLOAT":
            res = matching.match_pair_batch(stack, counts, pairs, ratio=0.8)
            putative = matching.matches_to_dict(pairs_np, res)
        else:
            putative = {}
            step = max(1, (1 << 32) // (16 * nmax * nmax))
            for s in range(0, n_pairs, step):
                pi, pj = pairs[s:s + step, 0].long(), pairs[s:s + step, 1].long()
                res = matching.match_brute_force_hamming(
                    stack[pi], stack[pj], col[None] < counts[pi][:, None],
                    col[None] < counts[pj][:, None], ratio=0.8)
                putative.update(matching.matches_to_dict(pairs_np[s:s + step], res))
                if s == 0:
                    first_batch = res
        torch.cuda.synchronize()
        t_match = time.perf_counter() - t
        launches = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in kernel_mods}
        t = time.perf_counter()
        kept = geometric_filter(scene, feats, putative, model="f", device=dev)
        torch.cuda.synchronize()
        t_filter = time.perf_counter() - t
        n_ok, n_all = epipolar_check(md, kept, Rs, Cs, K, size)
        share = n_ok / max(n_all, 1)
        rec = dict(features_s=secs["features"], match_s=t_match, filter_s=t_filter,
                   mean_features=float(n_feat.mean()), min_features=int(n_feat.min()),
                   max_features=int(n_feat.max()), putative_pairs=len(putative),
                   putative_matches=int(sum(len(m) for m in putative.values())),
                   pairs_kept=len(kept), matches=n_all, epipolar_share=share, launches=launches)
        log(f"[describers] {method}: features {secs['features']:.2f} s ({n_feat.mean():.1f} a "
            f"view, {n_feat.min()}..{n_feat.max()}), matches {t_match:.2f} s "
            f"({rec['putative_matches']} putative in {len(putative)}/{n_pairs} pairs), filter -g "
            f"f {t_filter:.2f} s: {len(kept)}/{n_pairs} pairs kept, {n_all} matches, "
            f"{100 * share:.2f}% within 4 px of the ground-truth epipolar line; launches "
            f"{launches}")
        if method == "AKAZE_FLOAT":
            if launches["two_nn"] != 1:
                fail(f"[describers] AKAZE_FLOAT matching made {launches['two_nn']} K1 launches, "
                     "not one")
            if len(kept) < 0.9 * n_pairs:
                fail(f"[describers] AKAZE_FLOAT kept only {len(kept)} of {n_pairs} pairs")
            if share < 0.95:
                fail(f"[describers] AKAZE_FLOAT: only {100 * share:.2f}% within 4 px")
            rec["k1_at_shape"] = k1_at_akaze_float(two_nn, stack, counts, pairs)
            rec["k1_at_shape"]["launches"] = launches["two_nn"]
            out["k1_inputs"] = (stack, counts, pairs)
        else:
            if len(putative) < n_pairs:
                fail(f"[describers] AKAZE_MLDB: {n_pairs - len(putative)} pairs without a "
                     "putative match")
            n_first = mldb_batch_check(stack, counts, pairs_np[:step], first_batch)
            log(f"[describers] AKAZE_MLDB: the first batch of the loop ({n_first} pairs, padded "
                "rows and masks as matched) equals a plain popcount 2-NN exactly: every Hamming "
                "product, and each valid row's distance, match and mask; pairs kept and the "
                "epipolar share printed, not gated")
        out[method] = rec

    # the warp check: one view warped on the card by the reference test's homography
    img = read_image(os.path.join(scene.root_path, scene.view_filename[0]), grayscale=True)
    H = warp_pair_h(size)
    warped = image_ops.warp_homography(torch.as_tensor(img, device=dev), H).to(torch.float32)
    f1, d1 = describe_image(img, "AKAZE_FLOAT", device=dev)
    f2, d2 = describe_image(warped.cpu().numpy(), "AKAZE_FLOAT", device=dev)
    res = matching.match_brute_force(torch.as_tensor(d1, device=dev),
                                     torch.as_tensor(d2, device=dev), ratio=0.8)
    ia = torch.nonzero(res.mask)[:, 0].cpu().numpy()
    ib = res.idx_b.cpu().numpy()[ia]
    proj = np.c_[f1[ia, :2], np.ones(len(ia))] @ H.T
    err = np.linalg.norm(proj[:, :2] / proj[:, 2:3] - f2[ib, :2], axis=1)
    agree = float((err < 3.0).mean()) if len(ia) else 0.0
    out["warp"] = dict(matches=len(ia), agree=agree)
    log(f"[describers] warp check (12 deg, scale 1.15, warped on the card): {len(ia)} AKAZE_FLOAT "
        f"matches, {100 * agree:.1f}% within 3 px of the homography")
    if len(ia) < 30 or agree < 0.7:
        fail(f"[describers] warp check: {len(ia)} matches, {100 * agree:.1f}% on the warp")

    # the other detectors and descriptors on one view, card against CPU
    sift_f = load_feats(os.path.join(run["md"], "img_00.feat"))
    det = {}
    for d in (dev, "cpu"):
        im = torch.as_tensor(img, device=d)
        torch.cuda.synchronize()
        t = time.perf_counter()
        xy, sc, ok = fast.fast_detect(im, threshold=0.06, max_corners=2048)
        lp = liop.liop_describe(im, sift_f[:, :2], sift_f[:, 2])
        dp = dipole.dipole_describe(im, sift_f[:, :2], sift_f[:, 2], sift_f[:, 3])
        torch.cuda.synchronize()
        det[str(d)] = (time.perf_counter() - t, xy[ok].cpu().numpy(), sc[ok].cpu().numpy(),
                       lp.cpu().numpy(), dp.cpu().numpy())
    g, c = det[str(dev)], det["cpu"]
    if not np.array_equal(g[1], c[1]) or np.abs(g[2] - c[2]).max() > 1e-6:
        fail("[describers] FAST on the card differs from the CPU run")
    liop_err, dip_err = float(np.abs(g[3] - c[3]).max()), float(np.abs(g[4] - c[4]).max())
    if liop_err > 1e-5 or dip_err > 1e-5:
        fail(f"[describers] LIOP / DIPOLE on the card differ from the CPU by {liop_err:.3g} / "
             f"{dip_err:.3g}")
    t = time.perf_counter()
    n_mser = len(mser.detect_mser(img))
    t_mser = time.perf_counter() - t
    t = time.perf_counter()
    n_tbmr = len(tbmr.detect_tbmr(img))
    t_tbmr = time.perf_counter() - t
    out["detectors"] = dict(fast_corners=len(g[1]), sift_keypoints=len(sift_f),
                            liop_max_abs_err=liop_err, dipole_max_abs_err=dip_err,
                            card_s=g[0], cpu_s=c[0], mser_regions=n_mser, mser_s=t_mser,
                            tbmr_regions=n_tbmr, tbmr_s=t_tbmr)
    log(f"[describers] one {size}^2 view: FAST {len(g[1])} corners equal to the CPU run; LIOP "
        f"and DIPOLE at its {len(sift_f)} SIFT keypoints within {liop_err:.3g} / {dip_err:.3g} "
        f"of the CPU run (FAST + LIOP + DIPOLE {g[0]:.3f} s on the card, {c[0]:.3f} s on the "
        f"CPU); host code: MSER {n_mser} regions in {t_mser:.2f} s, TBMR {n_tbmr} regions in "
        f"{t_tbmr:.2f} s")
    return out


def phase_spherical(kernel_mods, work, dev, n_views=100, width=5376, height=2688,
                    n_obs=300_000):
    """A SPHERICAL scene of n_views equirectangular views on the reference
    ring (utils/synthetic.py spherical_room_dataset): filter -g a on its
    putative matches, then sfm -s INCREMENTAL and sfm -s GLOBAL, each with
    every kernel's count set to 0 just before and read just after."""
    import numpy as np

    from openmvg_torch.io.matches_io import load_matches
    from openmvg_torch.io.sfm_data import load_sfm_data
    from openmvg_torch.sfm.eval_quality import evaluate_against_gt
    from openmvg_torch.sfm.scene import Scene, rmse
    from openmvg_torch.utils.logging import stage_times
    from openmvg_torch.utils.synthetic import spherical_room_dataset

    t = time.perf_counter()
    root = os.path.join(work, "spherical")
    sfm, md, R_gt, C_gt = spherical_room_dataset(root, n_views=n_views, width=width,
                                                 height=height, n_obs=n_obs, device=dev)
    put = os.path.join(md, "matches.putative.bin")
    m = load_matches(put)
    n_match = sum(len(x) for x in m.values())
    log(f"[spherical] {n_views} SPHERICAL views of {width}x{height} on the ring of radius 2, "
        f"each point seen by its 5-17 nearest views, {len(m)} pairs up to 3 ring steps apart, "
        f"{n_match} putative matches (10% outliers, 0.5 px noise), written in "
        f"{time.perf_counter() - t:.1f} s")
    secs, _, launches = run_stages(kernel_mods, [("filter", [
        "filter", "-i", sfm, "-m", put, "-o", os.path.join(md, "matches.f.bin"), "-g", "a"])])
    kept = load_matches(os.path.join(md, "matches.f.bin"))
    out = dict(pairs=len(m), putative_matches=n_match, filter_a_s=secs["filter"],
               pairs_kept=len(kept), matches=sum(len(x) for x in kept.values()))
    log(f"[spherical] filter -g a (angular essential, the reference's model for spherical "
        f"pairs) {secs['filter']:.2f} s: {len(kept)}/{len(m)} pairs, {out['matches']} matches "
        f"kept")
    gt = Scene(view_filename=[f"v{i}.jpg" for i in range(n_views)],
               view_pose=np.arange(n_views, dtype=np.int32),
               view_intrinsic=np.zeros(n_views, np.int32), pose_valid=np.ones(n_views, bool),
               pose_R=R_gt, pose_C=C_gt)
    for engine in ("INCREMENTAL", "GLOBAL"):
        tag = f"[spherical {engine}]"
        recon = os.path.join(root, engine.lower())
        secs, printed, launches = run_stages(kernel_mods, [(
            "sfm", ["sfm", "-i", sfm, "-m", md, "-M", os.path.join(md, "matches.f.bin"),
                    "-o", recon, "-s", engine])])
        text = printed["sfm"].getvalue()
        done = SFM_DONE.search(text)
        if done is None:
            fail(f"{tag} the sfm stage printed no summary line")
        polish = int(done.group(1))
        scene = load_sfm_data(os.path.join(recon, "sfm_data.json"))
        stats = evaluate_against_gt(scene, gt)
        n_posed, err_px = int(scene.pose_valid.sum()), rmse(scene)
        rec = dict(s=secs["sfm"], engine=dict(stage_times), launches=launches, poses=n_posed,
                   landmarks=scene.n_landmarks, rmse_px=err_px,
                   position_rmse=stats.get("position_rmse"), polish_steps=polish,
                   triplets_ran="triplet translations" in text)
        log(f"{tag} sfm {secs['sfm']:.2f} s: {n_posed}/{n_views} poses, {scene.n_landmarks} "
            f"landmarks, rmse {err_px:.4f} px, position_rmse {stats.get('position_rmse')}, "
            f"{polish} f64 polish steps, launches {launches}")
        log(f"{tag} engine stage seconds: " + ", ".join(f"{k} {v:.3f}"
                                                       for k, v in stage_times.items()))
        if n_posed < math.ceil(0.98 * n_views):
            fail(f"{tag} only {n_posed} of {n_views} poses reconstructed")
        if not stats.get("ok") or not stats["position_rmse"] <= 0.004:
            fail(f"{tag} position_rmse {stats.get('position_rmse')} above 0.004 (0.2% of the "
                 "ring radius)")
        if not err_px < 1.0:
            fail(f"{tag} reprojection rmse {err_px:.4f} px is not below 1 px")
        for name in ("seg_sum", "smatvec"):
            if launches[name] <= 0:
                fail(f"{tag} the sfm stage did not launch {name}")
        if polish != 0:
            fail(f"{tag} the f64 polish accepted {polish} steps; it takes only one shared "
                 "plain-PINHOLE intrinsic")
        if rec["triplets_ran"]:
            fail(f"{tag} the triplet stage ran on a SPHERICAL scene")
        out[engine] = rec
    return out


def sphere_panorama(height, width, seed, dev):
    """A seeded RGB equirectangular panorama (H, W, 3) uint8: a sum of
    random sinusoids of the viewing direction, so that it is continuous
    across the seam and at the poles."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    k = torch.as_tensor(rng.normal(size=(3, 48, 3)) * rng.uniform(2, 60, (3, 48, 1)), device=dev)
    ph = torch.as_tensor(rng.uniform(0, 2 * np.pi, (3, 48)), device=dev)
    lat = (0.5 - (torch.arange(height, device=dev, dtype=torch.float64) + 0.5) / height) * math.pi
    lon = ((torch.arange(width, device=dev, dtype=torch.float64) + 0.5) / width - 0.5) * 2 * math.pi
    la, lo = torch.meshgrid(lat, lon, indexing="ij")
    d = torch.stack([torch.cos(la) * torch.sin(lo), -torch.sin(la), torch.cos(la) * torch.cos(lo)],
                    -1)
    img = torch.stack([torch.sin(d @ k[c].T + ph[c]).mean(-1) for c in range(3)], -1)
    return torch.clamp(127.5 + 400 * img, 0, 255).to(torch.uint8).cpu().numpy()


def phase_cubify(kernel_mods, work, dev, height=2688, width=5376):
    """One seeded panorama written as PNG through the CLI's cubify on the
    card; its six faces against the port's CPU run of the same resampler,
    within 1 gray level."""
    import numpy as np
    import torch

    from openmvg_torch.io.image import read_image, write_image
    from openmvg_torch.io.sfm_data import save_sfm_data
    from openmvg_torch.ops.spherical import spherical_to_cubic
    from openmvg_torch.utils.synthetic import _spherical_scene

    root = os.path.join(work, "cubify")
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    pano = sphere_panorama(height, width, 5, dev)
    write_image(os.path.join(root, "images", "pano.png"), pano)
    sc = _spherical_scene(1, width, height)
    sc.view_filename, sc.root_path = ["pano.png"], os.path.join(root, "images")
    save_sfm_data(sc, os.path.join(root, "sfm_data.json"))
    faces_dir = os.path.join(root, "faces")
    secs, _, launches = run_stages(kernel_mods, [("cubify", ["cubify", "-i",
                                                             os.path.join(root, "sfm_data.json"),
                                                             "-o", faces_dir])])
    t = time.perf_counter()
    cpu = spherical_to_cubic(torch.as_tensor(pano))[0].to(torch.uint8).numpy()
    t_cpu = time.perf_counter() - t
    worst = 0
    for f in range(6):
        face = read_image(os.path.join(faces_dir, f"pano_face{f}.png"))
        if face.shape != cpu[f].shape:
            fail(f"[cubify] face {f} has shape {face.shape}, not {cpu[f].shape}")
        worst = max(worst, int(np.abs(face.astype(int) - cpu[f].astype(int)).max()))
    log(f"[cubify] one {width}x{height} RGB panorama: cubify {secs['cubify']:.2f} s on the card "
        f"(PNG read and six {cpu.shape[1]}^2 PNG faces written), the CPU resampler "
        f"{t_cpu:.2f} s; faces within {worst} gray level(s) of the CPU run")
    if worst > 1:
        fail(f"[cubify] a face differs from the CPU run by {worst} gray levels")
    return dict(s=secs["cubify"], cpu_resample_s=t_cpu, max_gray_diff=worst,
                face=int(cpu.shape[1]))


def phase_vo(kernel_mods, work, dev, n_frames=60, size=1024, arc_step=0.014):
    """n_frames rendered views of the textured sphere a small arc step apart
    through the CLI's vo on the card: the share of frames that add a pose,
    and the median angle between estimated and true step directions, both
    in the first camera's frame."""
    import numpy as np
    import torch

    from openmvg_torch.io.image import read_image
    from openmvg_torch.ops import fast
    from openmvg_torch.utils.synthetic import render_textured_sphere_dataset

    focal = 1.2 * size
    # the renderer's ring is centred on theta 0, where its look-at's up
    # vector (nearly world z) meets the viewing direction and the image
    # turns half a turn: the sequence takes the views just past it, on one
    # side (KLT is not rotation invariant)
    src, _, Rs, Cs, _ = render_textured_sphere_dataset(
        os.path.join(work, "vo_render"), n_views=2 * n_frames + 1, size=size, focal=focal,
        seed=2, arc_step=arc_step, device=dev)
    views = list(range(n_frames + 1, 2 * n_frames + 1))
    Rs, Cs = Rs[views], Cs[views]
    imgdir = os.path.join(work, "vo", "frames")
    os.makedirs(imgdir, exist_ok=True)
    for f, v in enumerate(views):
        os.replace(os.path.join(src, f"img_{v:02d}.png"),
                   os.path.join(imgdir, f"frame_{f:03d}.png"))
    a, b = (torch.as_tensor(read_image(os.path.join(imgdir, f"frame_{f:03d}.png"),
                                       grayscale=True), device=dev) for f in (0, 1))
    xy, _, ok = fast.fast_detect(a, threshold=0.06, max_corners=1024)
    moved, ok2 = fast.klt_track(a, b, xy[ok])
    flow = float((moved - xy[ok])[ok2].norm(dim=1).median())
    traj_path = os.path.join(work, "vo", "trajectory.txt")
    secs, printed, launches = run_stages(kernel_mods, [("vo", ["vo", "-i", imgdir, "-o",
                                                               traj_path, "-f", str(focal)])])
    counts = [1] + [int(x) for x in re.findall(r": (\d+) poses", printed["vo"].getvalue())]
    traj = np.loadtxt(traj_path, ndmin=2)
    added = [f for f in range(1, n_frames) if counts[f] > counts[f - 1]]
    share = len(added) / (n_frames - 1)
    angles = []
    for k, f in enumerate(added):
        if f - 1 in added or f == 1:
            est = traj[k + 1] - traj[k]
            true = Rs[0] @ (Cs[f] - Cs[f - 1])
            c = est @ true / (np.linalg.norm(est) * np.linalg.norm(true))
            angles.append(math.degrees(math.acos(max(-1.0, min(1.0, c)))))
    med = float(np.median(angles)) if angles else float("inf")
    log(f"[vo] {n_frames} frames of {size}^2, arc step {arc_step} rad (median KLT motion "
        f"{flow:.2f} px a frame between the first two): vo {secs['vo']:.2f} s, "
        f"{len(added)}/{n_frames - 1} frames added a pose, median step direction error "
        f"{med:.2f} deg over {len(angles)} steps (max {max(angles, default=float('nan')):.2f})")
    if share < 0.9:
        fail(f"[vo] only {len(added)} of {n_frames - 1} frames added a pose")
    if not med < 10.0:
        fail(f"[vo] median step direction error {med:.2f} deg, not under 10")
    return dict(s=secs["vo"], frames=n_frames, frames_with_pose=len(added) + 1,
                median_step_angle_deg=med, max_step_angle_deg=max(angles), klt_motion_px=flow)


def parse_numbers(text):
    return [float(x) for x in re.findall(r"-?\d+(?:\.\d*)?(?:e[-+]?\d+)?", text)]


def openmvs_counts(path):
    """(images, vertices) of an openMVS .mvs file as export_openmvs writes it."""
    import struct

    with open(path, "rb") as f:
        b = f.read()
    pos = 12                                     # "MVSI", version, reserved

    def u64():
        nonlocal pos
        pos += 8
        return struct.unpack_from("<Q", b, pos - 8)[0]

    def skip_str():
        nonlocal pos
        n = u64()
        pos += n

    for _ in range(u64()):                       # platforms
        skip_str()
        for _ in range(u64()):                   # cameras
            skip_str()
            skip_str()
            pos += 8 + 8 * (9 + 9 + 3)
        n_poses = u64()
        pos += 8 * 12 * n_poses
    n_img = u64()
    for _ in range(n_img):
        skip_str()
        skip_str()
        pos += 16
    return n_img, u64()


def k1_library_chunked(stack, counts, pairs, chunk_bytes=4 << 30):
    """cdist + topk over every pair of `pairs` (a (P, 2) tensor), in chunks
    of pairs whose (chunk, Nmax, Nmax) float32 distances fit chunk_bytes."""
    import torch

    n = stack.shape[1]
    step = max(1, chunk_bytes // (4 * n * n))
    a_all = stack.float()
    out = []
    for s in range(0, pairs.shape[0], step):
        p = pairs[s:s + step].long()
        d = torch.cdist(a_all[p[:, 0]], a_all[p[:, 1]])
        out.append(torch.topk(d, 2, dim=-1, largest=False).values)
    return out


def k2_at_localize(seg_sum, scene, md, query, dev):
    """K2 at localize's shapes: the camera sums of one query's float64
    pose-only bundle adjustment (1 pose, 1 intrinsic, one row an inlier)
    built as cmd_localize builds it (the query's SIFT, match_query, the
    adaptive P3P, pose_problem) against camera_jtu_plain / camera_jtj_plain
    in float64, within 1e-12 (1 + S).  Times each half beside its bound and
    beside einsum, which computes the same sums when every row is of the
    one pose."""
    import numpy as np
    import torch

    from openmvg_torch import cli
    from openmvg_torch.io.image import read_image
    from openmvg_torch.models import cameras as cm
    from openmvg_torch.sfm import ba
    from openmvg_torch.sfm import localization as loc
    from openmvg_torch.sfm.describer import describe_image

    _, descs = cli._load_features_for_scene(scene, md)
    db = loc.build_landmark_database(scene, descs)
    iid = int(scene.view_intrinsic[0])
    prm = np.asarray(scene.cameras.params)[iid]
    kind = int(scene.cameras.kind[iid])
    w, h = float(scene.cameras.width[iid]), float(scene.cameras.height[iid])
    qf, qd = describe_image(read_image(query, grayscale=True), device=dev)
    res = loc.localize_image(db, qf, qd, cm.K_matrix_np(prm), w, h, kind=kind,
                             disto_params=prm[3:cm.N_PARAMS[kind]], refine=False, device=dev)
    if not res.found:
        fail("[tools] K2 at localize's shape: the query was not localized")
    x2d, X3d = loc.match_query(db, qf, qd, device=dev)
    params = np.zeros(cm.MAX_PARAMS)
    params[:cm.N_PARAMS[kind]] = prm[:cm.N_PARAMS[kind]]
    p = ba.with_plans(loc.pose_problem(res.R, res.C, params, kind, w, h, x2d[res.inliers],
                                       X3d[res.inliers], dev))
    r, Jp6, Ji8, _ = ba.jacobians(p, ba.BAConfig(), ba.cam_fast_ok(p))
    O = Jp6.shape[0]
    args = (Jp6, Ji8, (-r).contiguous(), p.obs_pose, p.obs_intr, 1, 1)
    out = {}
    for kind_ in ("jtu", "jtj"):
        got = camera_call(seg_sum, kind_, args, p.seg_plans)
        torch.cuda.synchronize()
        err = camera_check(seg_sum, kind_, got, args, 1e-12)
        if err is None:
            fail(f"[tools] K2 at localize's shape (O {O}, float64): camera_{kind_} outside "
                 "1e-12 (1 + S) of its plain version")
        ms = cuda_ms(lambda: camera_call(seg_sum, kind_, args, p.seg_plans), 50)
        if kind_ == "jtu":
            plain_ms = cuda_ms(lambda: seg_sum.camera_jtu_plain(*args), 20)
            lib = (lambda: (torch.einsum("oki,ok->i", Jp6, args[2]),
                            torch.einsum("oki,ok->i", Ji8, args[2])))
        else:
            plain_ms = cuda_ms(lambda: seg_sum.camera_jtj_plain(*args[:2], *args[3:]), 20)
            lib = (lambda: (torch.einsum("oki,okj->ij", Jp6, Jp6),
                            torch.einsum("oki,okj->ij", Ji8, Ji8)))
        lib_ms = cuda_ms(lib, 20)
        bound, by = camera_bound_ms(O, 1, 1, kind_, 8)
        log(f"[tools] K2 at localize's shape (camera_{kind_}, O {O}, P 1, I 1, float64): max "
            f"|err| {err:.3g} within 1e-12 (1 + S); kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, einsum {lib_ms:.4f} ms, bound {bound:.3g} ms ({by}); "
            f"{bound / ms * 100:.3g}% of the bound")
        out[kind_] = dict(O=O, P=1, I=1, dtype="float64", max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by)
    return out


def k2_at_cluster(seg_sum, scene, posed, dev):
    """K2 at cluster's shape: the Lloyd sums of k-means on the posed
    centres (float32, 3 columns, 4 clusters; the final assignment of
    cluster_views' own k-means) against seg_sum_plain in float64, within
    1e-5 (1 + S); times beside index_add_ and the bound."""
    import numpy as np
    import torch

    from openmvg_torch.ops import vlad

    X = torch.as_tensor(scene.pose_C[scene.view_pose[posed]].astype(np.float32), device=dev)
    _, assign = vlad.kmeans(torch.Generator().manual_seed(0), X, 4)
    got = vlad.cluster_sums(X, assign, 4)
    err = seg_sum_check(seg_sum, got, X, assign, 4, 1e-5)
    if err is None:
        fail(f"[tools] K2 at cluster's shape ({X.shape[0]} x 3, 4 clusters) differs from "
             "seg_sum_plain beyond 1e-5 (1 + S)")
    ms = cuda_ms(lambda: vlad.cluster_sums(X, assign, 4), 50)
    plain_ms = cuda_ms(lambda: seg_sum.seg_sum_plain(X, assign, 4), 50)
    lib_ms = cuda_ms(lambda: library_seg_sum(X, assign, 4), 50)
    bound, by = seg_sum_bound_ms(X.shape[0], 3, 4, 4)
    log(f"[tools] K2 at cluster's Lloyd sums ({X.shape[0]} rows x 3, 4 clusters): max |err| "
        f"{err:.3g} within 1e-5 (1 + S); kernel {ms:.4f} ms (its plan included), plain "
        f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, bound {bound:.3g} ms ({by}); "
        f"{bound / ms * 100:.3g}% of the bound")
    return dict(O=int(X.shape[0]), D=3, num=4, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by)


def k1_f32_check(got, ref, where):
    """K1's float32 outputs against the plain version's: d1 and d2 within
    1e-4 (1 + |d|), idx1 equal away from near-ties.  Returns the largest
    |d - d_plain|; fails the run otherwise."""
    err = 0.0
    for x, y, what in zip(got[:2], ref[:2], ("d1", "d2")):
        bad = (x - y).abs() > 1e-4 * (1 + y.abs())
        if bad.any():
            fail(f"{where}: {what} outside 1e-4 (1 + |d|) in {int(bad.sum())} entries")
        err = max(err, float((x - y).abs().max()))
    near_tie = (ref[1] - ref[0]) <= 2e-4 * (1 + ref[0])
    bad = (got[2] != ref[2]) & ~near_tie
    if bad.any():
        fail(f"{where}: {int(bad.sum())} indices differ away from a tie")
    return err


def k1_at_bench_ann(two_nn, dev):
    """K1 at bench-ann's brute-force shape: the SIFT source's query and
    base descriptors (float32, D 128), built as cmd_bench_ann builds them,
    against two_nn_plain: d1 and d2 within 1e-4 (1 + |d|), idx1 equal away
    from near-ties; times beside cdist + topk and the bound."""
    import numpy as np
    import torch

    from openmvg_torch import cli

    base, query = cli.ann_sift_descriptors(np.random.default_rng(0), 4096, dev)
    a = torch.as_tensor(query, device=dev)
    b = torch.as_tensor(base, device=dev)
    err = k1_f32_check(two_nn.two_nn_fused(a, b), two_nn.two_nn_plain(a, b),
                       "[tools] K1 at bench-ann's shape")
    ms = cuda_ms(lambda: two_nn.two_nn_fused(a, b), 20)
    plain_ms = cuda_ms(lambda: two_nn.two_nn_plain(a, b), 20)
    lib_ms = cuda_ms(lambda: library_two_nn(a, b), 20)
    n, m, D = a.shape[0], b.shape[0], a.shape[1]
    t_ops = 2.0 * n * m * D / H100_F32_FLOPS
    t_bytes = ((n + m) * D * 4 + n * 12) / H100_BYTES
    bound, by = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
    log(f"[tools] K1 at bench-ann's brute force ({n} queries x {m}, D {D} float32): max |err| "
        f"{err:.3g} within 1e-4 (1 + |d|) of the plain version; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, cdist + topk {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}); "
        f"{bound / ms * 100:.2f}% of the bound")
    return dict(n=n, m=m, dim=D, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by=by)


# The observation sets of the L-inf check, each with its centre gate: every
# observation the reconstruction kept (logged), those the L2 scene
# reprojects within 1 px (about 2.6 times its 0.38 px rmse) and within
# 0.5 px.  An L-inf estimate is as good as the largest residual of its
# data: on the H100 the projective resection's centres read 0.0152 from
# the L2 scene and 0.0167 from the renderer's at 1 px, 0.0035 and 0.0036
# at 0.5 px, so the 1 px gate is set from that reading.  The 0.5 px set
# also runs on the CPU.
LINF_SETS = {"kept": (math.inf, None), "1px": (1.0, 0.03), "0.5px": (0.5, 0.006)}
LINF_CPU_TWIN = "0.5px"


def linf_check(scene, posed, ok, Cs, align, dev):
    """triangulate_linf on the 1,000 longest tracks in one batched call and
    resection_linf on 10 views (up to 1,000 points each), for every set of
    LINF_SETS on the card, and for LINF_CPU_TWIN also on the CPU.  Gates:
    the card within 1e-6 relative of the CPU; in every set each point within
    0.01 of the L2 scene's; each centre within the set's gate of the L2
    scene's and of the renderer's after the eval alignment (the renderer's
    units)."""
    import numpy as np
    import torch

    from openmvg_torch.models import cameras as cm
    from openmvg_torch.ops import linfinity, resection
    from openmvg_torch.sfm.scene import reprojection_residuals

    s_e, R_e, t_e = align
    Kv = cm.K_matrix_np(np.asarray(scene.cameras.params))
    P_all = {v: Kv[scene.view_intrinsic[v]] @ np.concatenate(
        [scene.pose_R[scene.view_pose[v]],
         (-scene.pose_R[scene.view_pose[v]] @ scene.pose_C[scene.view_pose[v]])[:, None]], 1)
        for v in posed}
    r, info = reprojection_residuals(scene)
    rn = np.full(scene.n_observations, np.inf)
    rn[info["obs_idx"]] = np.linalg.norm(r, axis=1)
    # resection fixes P[2, 3] = 1, the world origin's depth, so the world
    # origin moves to the landmarks' centroid, in front of every camera
    ctr = scene.X[scene.X_valid].mean(0)
    rv = posed[::max(1, len(posed) // 10)][:10]
    C_l2 = np.stack([scene.pose_C[scene.view_pose[v]] for v in rv])

    def inputs(within):
        use = ok & (rn <= within)
        by_lm = {}
        for i in np.nonzero(use)[0]:
            if int(scene.obs_view[i]) in P_all:
                by_lm.setdefault(int(scene.obs_landmark[i]), []).append(i)
        # the 1,000 longest tracks: the widest baselines
        lms = sorted(by_lm, key=lambda l: (-len(by_lm[l]), l))[:1000]
        vmax = max(len(by_lm[l]) for l in lms)
        P = np.zeros((len(lms), vmax, 3, 4))
        x = np.zeros((len(lms), vmax, 2))
        valid = np.zeros((len(lms), vmax), bool)
        for k, l in enumerate(lms):
            for j, i in enumerate(by_lm[l]):
                P[k, j], x[k, j], valid[k, j] = P_all[int(scene.obs_view[i])], scene.obs_x[i], True
        per_view = [np.nonzero(use & (scene.obs_view == v))[0][:1000] for v in rv]
        nmax = max(len(p) for p in per_view)
        x2d, X3d = np.zeros((len(rv), nmax, 2)), np.zeros((len(rv), nmax, 3))
        vv = np.zeros((len(rv), nmax), bool)
        for k, idx in enumerate(per_view):
            x2d[k, :len(idx)] = scene.obs_x[idx]
            X3d[k, :len(idx)] = scene.X[scene.obs_landmark[idx]] - ctr
            vv[k, :len(idx)] = True
        return dict(lms=lms, vmax=vmax, nmax=nmax, tri=(P, x, valid), res=(x2d, X3d, vv),
                    max_px=float(rn[use].max()))

    def solve(inp, d):
        def T(a):
            return torch.as_tensor(a, device=d)

        if d != "cpu":
            torch.cuda.synchronize()
        tt = time.perf_counter()
        Xl, gl = linfinity.triangulate_linf(*map(T, inp["tri"]))
        Pr, gr = linfinity.resection_linf(*map(T, inp["res"]))
        Kr, Rr, tr_ = resection.krt_from_P(Pr)
        Cr = -torch.einsum("vji,vj->vi", Rr, tr_) + T(ctr)
        return [a.cpu().numpy() for a in (Xl, gl, Pr, gr, Cr)] + [time.perf_counter() - tt]

    out = {}
    for name, (within, c_gate) in LINF_SETS.items():
        t0 = time.perf_counter()
        inp = inputs(within)
        res = solve(inp, dev)
        # in the renderer's units: the eval alignment's scale s_e
        rec = dict(
            within_px=within if math.isfinite(within) else None, max_residual_px=inp["max_px"],
            tracks=len(inp["lms"]), track_views_max=inp["vmax"], views=len(rv),
            points_per_view_max=inp["nmax"], card_s=res[5],
            X_err=s_e * float(np.linalg.norm(res[0] - scene.X[inp["lms"]], axis=1).max()),
            C_err=s_e * float(np.linalg.norm(res[4] - C_l2, axis=1).max()),
            C_err_truth=float(np.linalg.norm(s_e * res[4] @ R_e.T + t_e - Cs[rv], axis=1).max()),
            C_l2_err_truth=float(np.linalg.norm(s_e * C_l2 @ R_e.T + t_e - Cs[rv], axis=1).max()),
            gamma_tri_median=float(np.median(res[1])), gamma_res_max=float(res[3].max()),
            centre_gate=c_gate)
        if name == LINF_CPU_TWIN:
            cpu = solve(inp, "cpu")
            rec.update(cpu_s=cpu[5], card_vs_cpu_rel=max(
                float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
                for a, b in zip(res[:5], cpu[:5])))
        rec["s"] = time.perf_counter() - t0
        out[name] = rec
        log(f"[tools] L-inf on the observations {name} ({rec['max_residual_px']:.3f} px the "
            f"largest L2 residual): {rec['tracks']} tracks (up to {rec['track_views_max']} "
            f"views) and {rec['views']} resections (up to {rec['points_per_view_max']} points) "
            f"in {rec['card_s']:.2f} s on the card"
            + (f", {rec['cpu_s']:.2f} s on the CPU, card vs CPU max relative difference "
               f"{rec['card_vs_cpu_rel']:.3g}" if "cpu_s" in rec else "")
            + f"; points within {rec['X_err']:.5f} and centres within {rec['C_err']:.5f} of "
            f"the L2 scene, centres within {rec['C_err_truth']:.5f} of the renderer's after "
            f"the eval alignment (the L2 centres {rec['C_l2_err_truth']:.5f}); median "
            f"triangulation gamma {rec['gamma_tri_median']:.4f} px, largest resection gamma "
            f"{rec['gamma_res_max']:.4f} px")
        if name == LINF_CPU_TWIN and rec["card_vs_cpu_rel"] > 1e-6:
            fail(f"[tools] the L-inf solvers on the card differ from the CPU by "
                 f"{rec['card_vs_cpu_rel']:.3g} relative")
        if rec["X_err"] > 0.01:
            fail(f"[tools] L-inf points on {name}: {rec['X_err']:.5f} from the L2 scene (> 0.01)")
        if c_gate is not None and max(rec["C_err"], rec["C_err_truth"]) > c_gate:
            fail(f"[tools] L-inf centres on {name}: {rec['C_err']:.5f} from the L2 scene, "
                 f"{rec['C_err_truth']:.5f} from the renderer's (> {c_gate})")
    out["s"] = sum(r["s"] for r in out.values() if isinstance(r, dict))
    return out


def phase_tools(kernel_mods, run, srun, n_views, dev="cuda"):
    """The rest of the SfM layer and the CLI's tools on the pipeline's run
    directory and the INCREMENTAL scene, each step with every kernel's count
    set to 0 just before and read just after (the gates of the module
    note).  Returns each step's seconds, launches and readings."""
    import shutil

    import numpy as np
    import torch

    from openmvg_torch import cli
    from openmvg_torch.geometry.geodesy import lla_to_ecef
    from openmvg_torch.geometry.similarity import align_poses_rts
    from openmvg_torch.io.image import read_image, write_image
    from openmvg_torch.io.matches_io import load_matches, save_matches
    from openmvg_torch.io.sfm_data import load_sfm_data, save_sfm_data
    from openmvg_torch.models import cameras as cm
    from openmvg_torch.ops.image_ops import undistort_image
    from openmvg_torch.sfm import ba
    from openmvg_torch.sfm.scene import rmse
    from openmvg_torch.utils.synthetic import render_textured_sphere_dataset

    md, work, gtdir = run["md"], run["work"], run["gtdir"]
    Rs, Cs, K, size = run["gt"]
    scene = load_sfm_data(os.path.join(srun["recon"], "sfm_data.json"))
    posed = [v for v in range(scene.n_views)
             if scene.view_pose[v] >= 0 and scene.pose_valid[scene.view_pose[v]]]
    tw = os.path.join(work, "tools")
    os.makedirs(tw, exist_ok=True)
    # the tools read and write the scene as .bin: the same scene, and
    # 100-view JSON files take seconds each to write and read
    scene_path = os.path.join(tw, "scene.bin")
    save_sfm_data(scene, scene_path)
    out, launches_by_step = {"scene_bin": scene_path}, {}

    def step(name, stages):
        secs, printed, launches = run_stages(kernel_mods, stages)
        out[name] = dict(s=sum(secs.values()), launches=launches)
        launches_by_step[name] = launches
        return out[name], printed

    def gauge():
        """The eval alignment: the similarity taking the reconstruction's
        centres to the renderer's."""
        est = np.stack([scene.pose_C[scene.view_pose[v]] for v in posed])
        sim = align_poses_rts(torch.as_tensor(est), torch.as_tensor(Cs[posed]))
        return float(sim.scale), sim.R.numpy(), sim.t.numpy()

    s_e, R_e, t_e = gauge()

    # 1. localize 10 held-out views, halfway between ring views
    step_rad = min(2 * math.pi / n_views, 0.063)
    qv = list(range(n_views // 20, n_views, max(1, n_views // 10)))[:10]
    thetas = [(v + 0.5 - n_views / 2) * step_rad for v in qv]
    qdir = os.path.join(tw, "queries")
    _, _, _, qC, _ = render_textured_sphere_dataset(
        qdir, size=size, focal=K[0, 0], seed=1, thetas=thetas, device=dev)
    qimgs = [os.path.join(qdir, "images", f"img_{i:02d}.png") for i in range(len(thetas))]
    rec, printed = step("localize", [("localize", ["localize", "-i", scene_path, "-m", md,
                                                   "-q", *qimgs])])
    errs, inliers = [], []
    for i, line in enumerate(l for l in printed["localize"].getvalue().splitlines()
                             if l.startswith(qimgs[0][:-6])):
        if "localized with" not in line:
            continue
        inliers.append(int(line.split("localized with ")[1].split()[0]))
        C = np.asarray(json.loads(line.split("C = ")[1]))
        errs.append(float(np.linalg.norm(s_e * R_e @ C + t_e - qC[i])))
    rec.update(queries=len(qimgs), found=len(errs), inliers=inliers, center_err=errs,
               s_per_query=rec["s"] / len(qimgs))
    log(f"[tools] localize: {len(errs)}/{len(qimgs)} queries localized, inliers {inliers}, "
        f"centre errors after the eval alignment {[round(e, 5) for e in errs]}, "
        f"{rec['s_per_query']:.3f} s a query, launches {rec['launches']}")
    if len(errs) < 9:
        fail(f"[tools] localize found only {len(errs)} of {len(qimgs)} queries")
    if max(errs) > 0.015:
        fail(f"[tools] a localized centre lies {max(errs):.4f} from the renderer's (> 0.015)")
    if rec["launches"]["seg_sum"] < 1:
        fail("[tools] localize did not launch K2")
    seg_sum, two_nn = kernel_mods[1], kernel_mods[0]
    out["k2_at_localize"] = k2_at_localize(seg_sum, scene, md, qimgs[0], dev)

    # 2. refine -n 30 twice: K3's gate declining the card, then as by default
    prob, _ = ba.problem_from_scene(scene, refine_intrinsics=ba.ADJUST_ALL, device=dev)
    cost0 = float(ba.robust_cost(prob, ba.BAConfig(), ba.cam_fast_ok(prob)))
    rmse0 = rmse(scene)
    del prob
    refined = {}
    for tag, fused in (("refine", False), ("refine_fused", True)):
        r = os.path.join(tw, f"{tag}.bin")
        gate = ba.k3_gate
        if not fused:
            ba.k3_gate = lambda p, group=None: False
        try:
            rec, printed = step(tag, [("refine", ["refine", "-i", scene_path, "-o", r,
                                                  "-n", "30"]),
                                      ("eval", ["eval", "-i", r, "-g", gtdir])])
        finally:
            ba.k3_gate = gate
        cost = float(printed["refine"].getvalue().split("BA: cost=")[1].split()[0])
        stats = json.loads(printed["eval"].getvalue())
        refined[tag] = rmse(load_sfm_data(r))
        rec.update(cost0=cost0, cost=cost, rmse0=rmse0, rmse=refined[tag],
                   position_rmse=stats.get("position_rmse"))
        log(f"[tools] {tag}: cost {cost0:.4f} -> {cost:.4f}, rmse {rmse0:.5f} -> "
            f"{refined[tag]:.5f} px, position_rmse {stats.get('position_rmse')}, "
            f"{rec['s']:.2f} s, launches {rec['launches']}")
        if not cost <= cost0 + 5e-5:         # refine prints 4 decimals
            fail(f"[tools] {tag} raised the cost from {cost0} to {cost}")
        if not refined[tag] <= rmse0 + 1e-3:
            fail(f"[tools] {tag} rmse {refined[tag]:.5f} px above the input's {rmse0:.5f} + 1e-3")
        if not stats.get("ok") or not stats["position_rmse"] <= 0.006:
            fail(f"[tools] {tag} position_rmse {stats.get('position_rmse')} above 0.006")
        if rec["launches"]["seg_sum"] < 1:
            fail(f"[tools] {tag} did not launch K2")
        if (rec["launches"]["smatvec"] > 0) != fused:
            fail(f"[tools] {tag}: K3 launched {rec['launches']['smatvec']} times")
    if abs(refined["refine"] - refined["refine_fused"]) > 1e-3:
        fail(f"[tools] refine's rmse {refined['refine']} and the fused run's "
             f"{refined['refine_fused']} differ by more than 1e-3 px")

    # 3. cluster -n 4
    cdir = os.path.join(tw, "clusters")
    rec, _ = step("cluster", [("cluster", ["cluster", "-i", scene_path, "-o", cdir,
                                           "-n", "4"])])
    files = sorted(os.listdir(cdir))
    union = set()
    for f in files:
        sub = load_sfm_data(os.path.join(cdir, f))
        union |= {v for v in range(sub.n_views)
                  if sub.view_pose[v] >= 0 and sub.pose_valid[sub.view_pose[v]]}
    rec.update(files=len(files), views=len(union))
    log(f"[tools] cluster -n 4: {len(files)} files, {len(union)} views in their union, "
        f"{rec['s']:.2f} s, launches {rec['launches']}")
    if len(files) != 4 or union != set(posed):
        fail(f"[tools] cluster wrote {len(files)} files covering {len(union)} of "
             f"{len(posed)} posed views")
    if rec["launches"]["seg_sum"] < 1:
        fail("[tools] cluster did not launch K2")
    out["k2_at_cluster"] = k2_at_cluster(seg_sum, scene, posed, dev)

    # 4. geo-register --use_priors: the renderer's centres under a planted
    #    similarity into ECEF near Paris, scale 10, 10% of them outliers
    rng = np.random.default_rng(7)
    s_p = 10.0
    a = rng.normal(size=3)
    R_p = torch.linalg.matrix_exp(torch.as_tensor(
        [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])).numpy()
    base = np.asarray(lla_to_ecef(48.8566, 2.3522, 35.0))
    geo = load_sfm_data(scene_path)
    prior = s_p * Cs @ R_p.T + base
    outl = rng.choice(n_views, n_views // 10, replace=False)
    prior[outl] += rng.normal(scale=30.0, size=(len(outl), 3))
    geo.prior_center, geo.prior_center_weight = prior, np.ones((n_views, 3))
    gin, gout = os.path.join(tw, "geo_in.bin"), os.path.join(tw, "geo_out.bin")
    save_sfm_data(geo, gin)
    rec, printed = step("geo_register", [("geo-register", ["geo-register", "-i", gin, "-o",
                                                            gout, "--use_priors"])])
    scale = float(printed["geo-register"].getvalue().split("scale=")[1].split(")")[0])
    reg = load_sfm_data(gout)
    inl = [v for v in posed if v not in set(outl.tolist())]
    d = np.linalg.norm(np.stack([reg.pose_C[reg.view_pose[v]] for v in inl]) - prior[inl], axis=1)
    rec.update(scale=scale, planted=s_p, recovered=scale / s_e, median_err=float(np.median(d)))
    log(f"[tools] geo-register: scale {scale:.6g} (the reconstruction's gauge {s_e:.6g} taken "
        f"out: {scale / s_e:.6g} against the planted {s_p}), median registered centre "
        f"{rec['median_err']:.4f} from its inlier prior, {rec['s']:.2f} s")
    if abs(scale / s_e - s_p) > 0.01 * s_p:
        fail(f"[tools] geo-register recovered scale {scale / s_e:.5g}, planted {s_p}")
    if rec["median_err"] > 0.06:
        fail(f"[tools] geo-register median centre error {rec['median_err']:.4f} > 0.06")

    # 5. harmonize: 10 copies under planted per-channel gains and offsets
    init = load_sfm_data(run["sfm"])
    hin, hout = os.path.join(tw, "harm_in"), os.path.join(tw, "harm_out")
    os.makedirs(hin, exist_ok=True)
    planted = {}
    for v, name in enumerate(init.view_filename):
        src = os.path.join(init.root_path, name)
        if v in qv:
            g, o = rng.uniform(0.8, 1.2, 3), rng.uniform(-0.05, 0.05, 3)
            planted[v] = (g, o)
            im = read_image(src).astype(np.float64) / 255.0
            write_image(os.path.join(hin, name), np.clip(im * g + o, 0, 1))
        else:
            shutil.copyfile(src, os.path.join(hin, name))
    init.root_path = hin
    hscene = os.path.join(tw, "harm_scene.bin")
    save_sfm_data(init, hscene)
    ref_v = next(v for v in range(n_views) if v not in planted)
    rec, printed = step("harmonize", [("harmonize", [
        "harmonize", "-i", hscene, "-m", os.path.join(md, "matches.f.bin"), "-d", md,
        "-o", hout, "-r", str(ref_v)])])
    gains = {}
    for line in printed["harmonize"].getvalue().splitlines():
        m = re.match(r"\s+(\S+): gain=\[(.*)\] offset=\[(.*)\]", line)
        if m:
            gains[init.view_filename.index(m.group(1))] = (
                np.asarray(parse_numbers(m.group(2))), np.asarray(parse_numbers(m.group(3))))
    undo = max(max(np.abs(gains[v][0] - 1 / g).max(), np.abs(gains[v][1] + o / g).max())
               for v, (g, o) in planted.items())
    others = max(np.abs(gains[v][0] - 1).max() for v in gains if v not in planted)
    n_png = len([f for f in os.listdir(hout) if f.endswith(".png")])
    rec.update(planted_views=len(planted), undo_err=float(undo), others_gain_err=float(others),
               pngs=n_png)
    log(f"[tools] harmonize (reference view {ref_v}): the planted gains and offsets undone "
        f"within {undo:.4f}, the other views' gains within {others:.4f} of 1, {n_png} PNGs, "
        f"{rec['s']:.2f} s")
    if undo > 0.05 or others > 0.05 or n_png != n_views:
        fail(f"[tools] harmonize: undo error {undo:.4f}, others {others:.4f}, {n_png} PNGs")

    # 6. export -f in all 15 formats (undistorted on a copy whose camera has
    #    a planted radial distortion, so that the card resamples every view)
    edir = os.path.join(tw, "export")
    os.makedirs(edir, exist_ok=True)
    dist = load_sfm_data(scene_path)
    prm = np.asarray(dist.cameras.params).copy()
    prm[:, 3:6] = [-0.02, 0.0, 0.0]
    dist.cameras = dist.cameras._replace(kind=np.full_like(dist.cameras.kind,
                                                           cm.PINHOLE_RADIAL_K3), params=prm)
    dpath = os.path.join(tw, "distorted.bin")
    save_sfm_data(dist, dpath)
    fmts = ["json", "bin", "ply", "nvm", "colmap", "baf", "bundler", "pmvs", "mve", "openmvs",
            "agisoft", "meshlab", "mvstexturing", "cmpmvs", "frustums", "webgl", "undistorted"]
    ext = {"json": ".json", "bin": ".bin", "ply": ".ply", "nvm": ".nvm", "baf": ".baf",
           "bundler": ".out", "openmvs": ".mvs", "frustums": ".ply", "webgl": ".html"}
    stages = [(f, ["export", "-i", dpath if f == "undistorted" else scene_path,
                   "-o", os.path.join(edir, f + ext.get(f, "")), "-f", f]) for f in fmts]
    rec, _ = step("export", stages)
    for f in fmts:
        p = os.path.join(edir, f + ext.get(f, ""))
        size_b = (os.path.getsize(p) if os.path.isfile(p) else
                  sum(os.path.getsize(os.path.join(a, b)) for a, _, bs in os.walk(p) for b in bs))
        if size_b <= 0:
            fail(f"[tools] export -f {f} wrote nothing")
    ok = scene.obs_valid & scene.X_valid[scene.obs_landmark]
    seen_by = {}
    for i in np.nonzero(ok)[0]:
        seen_by.setdefault(int(scene.obs_landmark[i]), set()).add(int(scene.obs_view[i]))
    n_lm1 = sum(1 for vs in seen_by.values() if vs & set(posed))
    n_lm2 = sum(1 for vs in seen_by.values() if len(vs & set(posed)) >= 2)
    with open(os.path.join(edir, "nvm.nvm")) as fh:
        nv = fh.read().split("\n")
    nvm = (int(nv[2]), int(nv[3 + int(nv[2])]))
    with open(os.path.join(edir, "bundler.out")) as fh:
        bundler = tuple(int(x) for x in fh.read().split("\n")[1].split())
    with open(os.path.join(edir, "colmap", "images.txt")) as fh:
        n_img = (len(fh.read().split("\n")) - 2) // 2
    with open(os.path.join(edir, "colmap", "points3D.txt")) as fh:
        n_pts = len(fh.read().strip().split("\n")) - 1
    mvs = openmvs_counts(os.path.join(edir, "openmvs.mvs"))
    want = dict(nvm=(len(posed), n_lm1), bundler=(len(posed), n_lm1),
                colmap=(len(posed), scene.n_landmarks), openmvs=(len(posed), n_lm2))
    got = dict(nvm=nvm, bundler=bundler, colmap=(n_img, n_pts), openmvs=mvs)
    und = sorted(f for f in os.listdir(os.path.join(edir, "undistorted")) if f.endswith(".png"))
    v0 = dist.view_filename[0]
    im = torch.as_tensor(read_image(os.path.join(dist.root_path, v0)), dtype=torch.float32) / 255
    cpu = undistort_image(im.movedim(-1, 0), cm.PINHOLE_RADIAL_K3, prm[0],
                          float(dist.cameras.width[0]), float(dist.cameras.height[0]))
    cpu = np.clip(cpu.movedim(0, -1).numpy() * 255.0, 0, 255).astype(np.uint8).astype(int)
    card = read_image(os.path.join(edir, "undistorted", os.path.basename(v0))).astype(int)
    und_err = int(np.abs(card - cpu).max())
    rec.update(formats=len(fmts), counts=got, undistorted_pngs=len(und),
               undistorted_vs_cpu_max_gray=und_err)
    log(f"[tools] export: {len(fmts)} formats written; (poses, landmarks) {got} against "
        f"{want}; undistorted {len(und)} PNGs, view 0 within {und_err} gray level(s) of the "
        f"CPU undistort_image; {rec['s']:.2f} s")
    if got != want:
        fail(f"[tools] export counts {got} differ from the scene's {want}")
    if len(und) != n_views or und_err > 1:
        fail(f"[tools] export -f undistorted: {len(und)} PNGs, {und_err} gray levels off")

    # 7. the small tools
    fm = os.path.join(md, "matches.f.bin")
    first10 = os.path.join(tw, "first10.bin")
    fmatch = load_matches(fm)
    save_matches({p: fmatch[p] for p in sorted(fmatch)[:10]}, first10)
    sm = os.path.join(tw, "split", "m.bin")
    os.makedirs(os.path.dirname(sm), exist_ok=True)
    vp = os.path.join(work, "vlad_pairs.txt")
    t = {k: os.path.join(tw, k) for k in ("ff.txt", "co", "lpV.txt", "lpG.txt", "m.txt",
                                          "adj.svg", "tracks.txt", "kp", "ms", "ts")}
    rec, printed = step("small_tools", [
        ("frustum-filter", ["frustum-filter", "-i", scene_path, "-o", t["ff.txt"]]),
        ("change-origin", ["change-origin", "-i", scene_path, "-o", t["co"], "-f"]),
        ("list-pairs-V", ["list-pairs", "-i", scene_path, "-o", t["lpV.txt"], "-V", "-d", "2"]),
        ("list-pairs-G", ["list-pairs", "-i", gin, "-o", t["lpG.txt"], "-G"]),
        ("convert-matches", ["convert-matches", "-i", fm, "-o", t["m.txt"], "-a", t["adj.svg"]]),
        ("matches2tracks", ["matches2tracks", "-i", fm, "-o", t["tracks.txt"]]),
        ("split-matches", ["split-matches", "-i", fm, "-o", sm]),
        ("export-keypoints", ["export-keypoints", "-i", scene_path, "-d", md, "-o", t["kp"]]),
        ("export-matches", ["export-matches", "-i", scene_path, "-m", first10, "-d", md,
                            "-o", t["ms"]]),
        ("export-tracks", ["export-tracks", "-i", scene_path, "-m", first10, "-d", md,
                           "-o", t["ts"]]),
        ("retrieval-quality", ["retrieval-quality", "-i", scene_path, "-p", vp])])
    said = {k: v.getvalue() for k, v in printed.items()}

    def lines(p):
        with open(p) as fh:
            return [x for x in fh.read().split("\n") if x.strip()]

    tr = json.loads(said["matches2tracks"])
    tr_rows = [x.split() for x in lines(t["tracks.txt"])]
    rq = json.loads(said["retrieval-quality"])
    gt_pairs = {(min(a, b), max(a, b)) for vs in seen_by.values() for a in vs for b in vs if a != b}
    vpairs = {(min(i, j), max(i, j)) for i, j in cli.load_pairs_file(vp)}
    origin = np.asarray(parse_numbers(open(os.path.join(t["co"], "local_frame_origin.txt"))
                                      .read()))
    local = load_sfm_data(os.path.join(t["co"], "sfm_data_local.bin"))
    checks = {
        "frustum-filter": (int(said["frustum-filter"].split("/")[0]), len(lines(t["ff.txt"]))),
        "list-pairs-V": (int(said["list-pairs-V"].split()[0]), len(lines(t["lpV.txt"]))),
        "list-pairs-G": (int(said["list-pairs-G"].split()[0]), len(lines(t["lpG.txt"]))),
        "convert-matches": (sum(len(m) for m in fmatch.values()),
                            sum(len(m) for m in load_matches(t["m.txt"]).values())),
        "matches2tracks": ((tr["n_observations"], tr["n_tracks"]),
                           (len(tr_rows), len({r[0] for r in tr_rows}))),
        "split-matches": (int(said["split-matches"].split()[0]),
                          len(os.listdir(os.path.dirname(sm)))),
        "export-keypoints": (int(said["export-keypoints"].split()[0]), len(os.listdir(t["kp"]))),
        "export-matches": (int(said["export-matches"].split()[0]), len(os.listdir(t["ms"]))),
        "export-tracks": (int(said["export-tracks"].split()[0]), len(os.listdir(t["ts"]))),
        "retrieval-quality": ((rq["gt_pairs"], rq["putative_pairs"], rq["true_positive"]),
                              (len(gt_pairs), len(vpairs), len(gt_pairs & vpairs))),
        "change-origin": (0, int(np.abs(origin - scene.pose_C[min(
            p for p in range(scene.n_poses) if scene.pose_valid[p])]).max() > 1e-9
            or np.abs(local.pose_C + origin - scene.pose_C).max() > 1e-6)),
    }
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    rec.update(checks={k: v[0] for k, v in checks.items()})
    log(f"[tools] small tools: {len(checks)} checks, printed counts "
        f"{ {k: v[0] for k, v in checks.items()} }, {rec['s']:.2f} s")
    if bad:
        fail(f"[tools] printed counts differ from the files: {bad}")
    if not os.path.getsize(t["adj.svg"]) or checks["export-matches"][0] != 10:
        fail("[tools] convert-matches -a or export-matches wrote the wrong output")

    # 8. bench-ann --source sift --sweep
    rec, printed = step("bench_ann", [("bench-ann", ["bench-ann", "--source", "sift",
                                                     "--sweep"])])
    ann = json.loads(printed["bench-ann"].getvalue())
    r16 = {e["n"]: e["recall_vs_bruteforce"] for e in ann["sweep"] if e["top_c"] == 16}
    rec.update(n_query=ann["n_query"], bruteforce_s=ann["bruteforce"]["time_s"],
               cascade_s=ann["cascade"]["time_s"], sweep=ann["sweep"])
    log(f"[tools] bench-ann --source sift --sweep: {ann['n_query']} queries, brute force "
        f"{ann['bruteforce']['time_s']:.4f} s, cascade {ann['cascade']['time_s']:.4f} s, recall "
        f"at top_c 16 {r16}; sweep {ann['sweep']}; launches {rec['launches']}")
    if not r16 or min(r16.values()) < 0.90:
        fail(f"[tools] bench-ann recall at top_c 16 {r16} below 0.90")
    if rec["launches"]["two_nn"] < 1:
        fail("[tools] bench-ann did not launch K1")
    out["k1_at_bench_ann"] = k1_at_bench_ann(two_nn, dev)

    # 9. the L-infinity solvers: 1,000 tracks in one call, 10 views' resections
    out["linf"] = linf_check(scene, posed, ok, Cs, (s_e, R_e, t_e), dev)

    # 10. --profile DIR on refine, in a process of its own as a user runs it
    #     (a large profiler session leaves later ones in the same process
    #     short of their first events: the measure phase's come after this)
    pdir = os.path.join(tw, "profile")
    t1 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "openmvg_torch.cli", "--profile", pdir, "refine",
                        "-i", scene_path, "-o", os.path.join(tw, "prof.bin"), "-n", "3"],
                       capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    rec = out["profile"] = dict(s=time.perf_counter() - t1, rc=r.returncode)
    traces = [os.path.join(pdir, f) for f in os.listdir(pdir)] if os.path.isdir(pdir) else []
    text = open(traces[0]).read() if traces else ""
    names = dict(k2=("seg_sum_kernel" in text or "camera_sums_kernel" in text),
                 stage="bundle_adjustment" in text)
    rec.update(trace_bytes=len(text), names=names)
    log(f"[tools] --profile: {len(traces)} trace(s), {len(text)} bytes, names {names}")
    if r.returncode != 0 or len(traces) != 1 or not all(names.values()):
        fail(f"[tools] --profile wrote {len(traces)} trace(s) naming {names}")

    out["launches_by_step"] = launches_by_step   # the profile step runs in its own process
    out["s"] = sum(r["s"] for r in out.values() if isinstance(r, dict) and "s" in r)
    return out


# ---------------------------------------------------------------------------
# multigpu: the sharded paths (openmvg_torch/parallel) on the card
# ---------------------------------------------------------------------------

MG_RANKS = 4
MG_TIMEOUT = 420          # seconds a spawned group may take
BIG_BA_STEPS = 3
BIG_BA_COST_REL = 1e-4    # float32 LM steps of 4.2 M observations: see phase_multigpu


def ring_problem_fields(n_views=8, n_points=61, seed=2, noise_X=0.02):
    """The float64 problem of the reference's point-sharded test: every
    visible point of ring_scene(n_views, n_points, seed) observed, the
    points perturbed by noise_X (the draws of tests/test_ba.py's
    scene_from_ring with seed + 1), as numpy fields."""
    import numpy as np
    import torch

    from openmvg_torch.models import cameras as cm
    from openmvg_torch.sfm import ba
    from openmvg_torch.sfm.scene import Scene
    from openmvg_torch.utils.synthetic import ring_scene

    s = ring_scene(n_views=n_views, n_points=n_points, seed=seed)
    rng = np.random.default_rng(seed + 1)
    sc = Scene()
    sc.view_filename = [f"v{i}.jpg" for i in range(n_views)]
    sc.view_intrinsic = np.zeros(n_views, np.int32)
    sc.view_pose = np.arange(n_views, dtype=np.int32)
    sc.view_wh = np.tile([[1000, 1000]], (n_views, 1)).astype(np.int32)
    sc.cameras = cm.make_pinhole(1000, 1000, s.K[0, 0, 0], s.K[0, 0, 2], s.K[0, 1, 2])
    sc.pose_valid = np.ones(n_views, bool)
    sc.pose_R, sc.pose_C = s.R.copy(), s.C.copy()
    sc.X = s.X + rng.normal(scale=noise_X, size=s.X.shape)
    sc.X_valid = np.ones(n_points, bool)
    ov, ol = np.nonzero(s.visible)
    sc.obs_landmark, sc.obs_view = ol.astype(np.int32), ov.astype(np.int32)
    sc.obs_x, sc.obs_feat = s.x[ov, ol], ol.astype(np.int32)
    sc.obs_valid = np.ones(len(ol), bool)
    p, _ = ba.problem_from_scene(sc, dtype=torch.float64)
    f = {k: getattr(p, k).numpy() for k in ba.BAProblem._fields[:16]}
    f["pt_obs"] = tuple(None if a is None else a.numpy() for a in p.pt_obs)
    return f


def _big_ba_steps(p, cfg, steps, group=None, shard_points=False):
    """The cost before and after each of `steps` LM steps, and the accepts."""
    import torch

    from openmvg_torch.sfm import ba

    p = ba.with_plans(p)
    fast = ba.cam_fast_ok(p)
    lam = torch.as_tensor(cfg.lam_init, dtype=p.X.dtype, device=p.X.device)
    costs = [float(ba.robust_cost(p, cfg, fast, group))]
    accepts = []
    for _ in range(steps):
        p, lam, cost, acc = ba.lm_step(p, lam, cfg, fast, group, shard_points)
        costs.append(float(cost))
        accepts.append(bool(acc))
    return p, costs, accepts


def _multigpu_ranks(rank, n, tasks):
    """A spawned rank of the multigpu phase: each task with every kernel's
    count set to 0 just before and read just after.  Returns {task: dict(s,
    launches, ...)}."""
    import torch

    from openmvg_torch.ops import seg_sum, smatvec, two_nn
    from openmvg_torch.parallel import dist_ba, runtime
    from openmvg_torch.parallel.mesh import make_mesh
    from openmvg_torch.sfm import ba
    from openmvg_torch.utils.synthetic import big_ba_problem

    mods = (two_nn, seg_sum, smatvec)
    mesh = make_mesh(n)
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
    out = {}
    for name, kind, arg in tasks:
        for m in mods:
            m.LAUNCHES = 0
        sync()
        t0 = time.perf_counter()
        rec = {}
        if kind == "cli":
            r = runtime.run_cli(rank, n, arg)
            rec.update(rc=r["rc"], stdout=r["stdout"])
        elif kind == "ba_small":
            p = ba.problem_from_reference(arg["fields"])
            fn = dist_ba.adjust_distributed if arg["mode"] == "obs" else \
                dist_ba.adjust_point_sharded
            q, cost = fn(p, mesh, ba.BAConfig(max_iterations=15))
            rec.update(cost=cost, rotvec=q.rotvec.numpy(), X=q.X.numpy())
        else:                       # ba_big: the host problem made here, its shard on the card
            p, O = big_ba_problem(**arg.get("size", {}))
            if arg["mode"] == "obs":
                local = dist_ba.local_shard(dist_ba.pad_problem(p, n), mesh, False)
            else:
                local, _ = dist_ba.local_point_shard(p, mesh)
            rows = int(local.obs_pose.shape[0])
            del p
            _, costs, accepts = _big_ba_steps(local, ba.BAConfig(), BIG_BA_STEPS, mesh.group,
                                              arg["mode"] == "point")
            rec.update(obs=O, local_rows=rows, costs=costs, accepts=accepts,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30
                       if mesh.device.type == "cuda" else None)
        sync()
        rec["s"] = time.perf_counter() - t0
        rec["launches"] = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in mods}
        out[name] = rec
    return out


def multigpu_shapes(seg_sum, two_nn, p, dev):
    """K1 and K2 at the shapes the sharded paths give them, against their
    plain versions on the same inputs, each timed beside its bound and its
    library call.  K2: mesh rank 0's shard of big_ba_problem `p` over
    MG_RANKS ranks in each sharded mode, as the ranks build it
    (dist_ba.local_shard / local_point_shard, ba.with_plans), at its first
    LM step's Jacobians: the point sums J_x^T r (k 3) and J_x^T J_x (k 9)
    through the shard's point_plan over its points (all 300,000 when
    observation-sharded, 75,000 when point-sharded), within 1e-5 (1 + S)
    (seg_sum_check), and the fused camera sums on the same rows (camera_check).
    K1: one rank's launch of scaling-bench -s 1,2,4 (pairs_per_device 256
    pairs of its 16 x 1,024 x 128 float32 stack, built as
    measure_weak_scaling builds it) within 1e-4 (1 + |d|), indices equal
    away from near-ties (k1_f32_check)."""
    import numpy as np
    import torch

    from openmvg_torch.parallel import dist_ba
    from openmvg_torch.parallel.mesh import Mesh
    from openmvg_torch.sfm import ba

    out = {}
    rank0 = Mesh(group=None, ranks=tuple(range(MG_RANKS)), rank=0, device=torch.device(dev))
    cfg = ba.BAConfig()
    shards = (("obs", lambda: dist_ba.local_shard(dist_ba.pad_problem(p, MG_RANKS), rank0,
                                                   False)),
              ("point", lambda: dist_ba.local_point_shard(p, rank0)[0]))
    for mode, make in shards:
        q = ba.with_plans(make())
        r, Jp6, Ji8, Jx3 = ba.jacobians(q, cfg, ba.cam_fast_ok(q))
        O, L, P, I = Jx3.shape[0], q.X.shape[0], q.rotvec.shape[0], q.intr_params.shape[0]
        ids, plan = q.obs_point, q.point_plan
        for name, vals in (("point_jtr_k3", ba._brmatvec(Jx3, r).contiguous()),
                           ("point_jtj_k9", ba._outer_flat(Jx3).contiguous())):
            got = seg_sum.seg_sum(vals, ids, L, plan)
            torch.cuda.synchronize()
            err = seg_sum_check(seg_sum, got, vals, ids, L, 1e-5)
            if err is None:
                fail(f"[multigpu] seg_sum {name} on a {mode}-sharded rank's rows: outside "
                     "1e-5 (1 + S)")
            k = vals.shape[1]
            ms = cuda_ms(lambda: seg_sum.seg_sum(vals, ids, L, plan), 20)
            plain_ms = cuda_ms(lambda: seg_sum.seg_sum_plain(vals, ids, L), 5)
            lib_ms = cuda_ms(lambda: library_seg_sum(vals, ids, L), 5)
            bound, by = seg_sum_bound_ms(O, k, L, vals.element_size())
            log(f"[multigpu] seg_sum {name}, {mode}-sharded rank 0 (O {O}, k {k}, num {L}): "
                f"max |err| {err:.3g} within 1e-5 (1 + S); kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}); "
                f"{bound / ms * 100:.2f}% of the bound")
            out[f"{mode}_{name}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                         bound_ms=bound, bound_by=by, max_abs_err=err, O=O,
                                         k=k, num=L)
        args = (Jp6, Ji8, (-r).contiguous(), q.obs_pose, q.obs_intr, P, I)
        for kind in ("jtu", "jtj"):
            got = camera_call(seg_sum, kind, args, q.seg_plans)
            torch.cuda.synchronize()
            err = camera_check(seg_sum, kind, got, args, 1e-5)
            if err is None:
                fail(f"[multigpu] camera_{kind} on a {mode}-sharded rank's rows: outside "
                     "1e-5 (1 + S)")
            ms = cuda_ms(lambda: camera_call(seg_sum, kind, args, q.seg_plans), 20)
            plain_fn = seg_sum.camera_jtu_plain if kind == "jtu" else seg_sum.camera_jtj_plain
            pargs = args if kind == "jtu" else args[:2] + args[3:]
            plain_ms = cuda_ms(lambda: plain_fn(*pargs), 5)
            bound, by = camera_bound_ms(O, P, I, kind, Jp6.element_size())
            log(f"[multigpu] camera_{kind}, {mode}-sharded rank 0 (O {O}, P {P}, I {I}): "
                f"max |err| {err:.3g} within 1e-5 (1 + S); kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}); "
                f"{bound / ms * 100:.2f}% of the bound")
            out[f"{mode}_camera_{kind}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                                bound_ms=bound, bound_by=by, max_abs_err=err,
                                                O=O, P=P, I=I)
        del q, r, Jp6, Ji8, Jx3, args

    rng = np.random.default_rng(0)
    n_views, n_feats, n_pairs = 16, 1024, 256
    descs = torch.as_tensor(rng.integers(0, 255, (n_views, n_feats, 128)).astype(np.float32),
                            device=dev)
    counts = torch.full((n_views,), n_feats, dtype=torch.int32, device=dev)
    all_pairs = np.asarray([(i, j) for i in range(n_views) for j in range(i + 1, n_views)])
    pairs = torch.as_tensor(np.resize(all_pairs, (n_pairs, 2)).astype(np.int32), device=dev)
    err = k1_f32_check(two_nn.two_nn_batch(descs, counts, pairs),
                       two_nn.two_nn_batch_plain(descs, counts, pairs),
                       "[multigpu] K1 at scaling-bench's shape")
    ms = cuda_ms(lambda: two_nn.two_nn_batch(descs, counts, pairs), 10)
    plain_ms = cuda_ms(lambda: two_nn.two_nn_batch_plain(descs, counts, pairs), 3, 1)
    a_all, b_all = descs[pairs[:, 0].long()], descs[pairs[:, 1].long()]
    lib_ms = cuda_ms(lambda: library_two_nn(a_all, b_all), 3, 1)
    bound, by = two_nn_bound_ms(descs, counts, pairs, n_pairs * n_feats, int8=False)
    log(f"[multigpu] K1 at scaling-bench's shape ({n_pairs} pairs of {n_feats} x {n_feats}, "
        f"D 128 float32, one launch): max |err| {err:.3g} within 1e-4 (1 + |d|); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, cdist + topk {lib_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({by}); {bound / ms * 100:.2f}% of the bound")
    out["scaling_k1"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                             bound_by=by, max_abs_err=err, pairs=n_pairs, n=n_feats, dim=128)
    return out


def phase_multigpu(kernel_mods, run, srun, trun, dev="cuda"):
    """The sharded paths on the card (the gates of the module note): (a)
    refine -d 4 through the CLI as a NCCL world of one and over 4 gloo ranks
    sharing the card; then one spawned group of 4 gloo ranks on the card
    for (b) both sharded BA modes against the same solve in one rank, (c)
    matches --ring_matching on and (d) scaling-bench -s 1,2,4.  K3 stays
    off in every sharded run."""
    import numpy as np
    import torch

    from openmvg_torch.ops import seg_sum, two_nn
    from openmvg_torch.parallel import runtime
    from openmvg_torch.sfm import ba
    from openmvg_torch.utils.synthetic import big_ba_problem

    t_all = time.perf_counter()
    # ranks that share the card need the memory this process keeps cached
    alloc, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    log(f"[multigpu] this process: {alloc / 2**30:.2f} GiB allocated, {reserved / 2**30:.2f} "
        f"GiB reserved, {torch.cuda.memory_reserved() / 2**30:.2f} GiB after empty_cache")
    md, gtdir = run["md"], run["gtdir"]
    scene_path = trun["scene_bin"]
    tw = os.path.join(run["work"], "multigpu")
    os.makedirs(tw, exist_ok=True)
    single = trun["refine"]
    out = {}
    saved = {k: os.environ.get(k) for k in ("OMT_DIST_BACKEND",)}
    try:
        # (a) refine -d 4 through the CLI, twice
        for tag, backend in (("refine_d4_nccl", None), ("refine_d4_gloo", "gloo")):
            if backend:
                os.environ["OMT_DIST_BACKEND"] = backend
            else:
                os.environ.pop("OMT_DIST_BACKEND", None)
            r = os.path.join(tw, f"{tag}.bin")
            secs, printed, launches = run_stages(
                kernel_mods, [("refine", ["refine", "-i", scene_path, "-o", r, "-n", "30",
                                          "-d", str(MG_RANKS)]),
                              ("eval", ["eval", "-i", r, "-g", gtdir])])
            text = printed["refine"].getvalue()
            m = re.search(r"distributed BA over (\d+) devices: cost=(\S+)", text)
            ranks = [json.loads(x) for x in
                     re.findall(r"rank \d+ \(\w+\) kernel launches: (\{.*\})", text)]
            clamp = [ln for ln in text.splitlines() if ln.startswith("refine -d")]
            stats = json.loads(printed["eval"].getvalue())
            if m is None:
                fail(f"[multigpu] {tag}: no distributed line in {text!r}")
            n, cost = int(m.group(1)), float(m.group(2))
            rec = out[tag] = dict(s=sum(secs.values()), refine_s=secs["refine"], ranks=n,
                                  cost=cost, cost0=single["cost0"],
                                  position_rmse=stats.get("position_rmse"),
                                  single_position_rmse=single["position_rmse"],
                                  rank_launches=ranks, parent_launches=launches,
                                  clamp=clamp[0] if clamp else None)
            log(f"[multigpu] {tag}: {n} rank(s){', ' + clamp[0] if clamp else ''}; cost "
                f"{single['cost0']:.4f} -> {cost:.4f}, position_rmse "
                f"{stats.get('position_rmse')} (single card {single['position_rmse']}), "
                f"{secs['refine']:.2f} s; launches by rank {ranks}")
            want = torch.cuda.device_count() if backend is None else MG_RANKS
            if n != min(want, MG_RANKS) or len(ranks) != n:
                fail(f"[multigpu] {tag} ran {n} rank(s) ({len(ranks)} reported), not {want}")
            if backend is None and n < MG_RANKS and not clamp:
                fail(f"[multigpu] {tag} clamped to {n} without printing the clamp")
            if not cost <= single["cost0"] + 5e-5:
                fail(f"[multigpu] {tag} raised the cost from {single['cost0']} to {cost}")
            pr = stats.get("position_rmse")
            if not stats.get("ok") or not pr <= 0.006 or \
                    not abs(pr - single["position_rmse"]) <= 1e-4:
                fail(f"[multigpu] {tag} position_rmse {pr}: above 0.006 or more than 1e-4 "
                     f"from the single card's {single['position_rmse']}")
            if any(x["seg_sum"] < 1 for x in ranks):
                fail(f"[multigpu] {tag}: a rank did not launch K2: {ranks}")
            if any(x["smatvec"] for x in ranks) or launches["smatvec"]:
                fail(f"[multigpu] {tag}: K3 launched in a sharded solve")
        os.environ["OMT_DIST_BACKEND"] = "gloo"

        # (b), (c), (d): one group of 4 gloo ranks on the card
        small = ring_problem_fields()
        ring_out = os.path.join(tw, "matches.ring.bin")
        tasks = [("ba_small_obs", "ba_small", dict(mode="obs", fields=small)),
                 ("ba_small_point", "ba_small", dict(mode="point", fields=small)),
                 ("ba_big_obs", "ba_big", dict(mode="obs")),
                 ("ba_big_point", "ba_big", dict(mode="point")),
                 ("ring", "cli", ["matches", "-i", run["sfm"], "-o", ring_out, "-d", md,
                                  "-p", os.path.join(md, "pairs.txt"), "-r", "0.8",
                                  "--ring_matching", "on"]),
                 ("scaling", "cli", ["scaling-bench", "-s", "1,2,4"])]
        t0 = time.perf_counter()
        res = runtime.spawn(_multigpu_ranks, MG_RANKS, device=dev, backend="gloo",
                            args=(tasks,), timeout=MG_TIMEOUT)
        out["group_s"] = time.perf_counter() - t0
        for name, _, _ in tasks:
            per = [r[name]["launches"] for r in res]
            out.setdefault("task_s", {})[name] = [r[name]["s"] for r in res]
            out.setdefault("rank_launches", {})[name] = per
            if any(x["smatvec"] for x in per):
                fail(f"[multigpu] {name}: K3 launched in a sharded run")
        log(f"[multigpu] one group of {MG_RANKS} gloo ranks on the card: "
            f"{out['group_s']:.1f} s; seconds by task and rank {out['task_s']}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # (b) against the same solve in one rank on the card
    cfg = ba.BAConfig(max_iterations=15)
    one, cost1, _ = ba.adjust(ba.problem_from_reference(small, torch.float64, dev), cfg)
    for mode in ("obs", "point"):
        got = res[0][f"ba_small_{mode}"]
        rel = abs(got["cost"] - cost1) / max(cost1, 1e-12)    # the reference test's rule
        drot = float(np.abs(got["rotvec"] - one.rotvec.cpu().numpy()).max())
        dX = float(np.abs(got["X"][:one.X.shape[0]] - one.X.cpu().numpy()).max())
        out[f"ba_small_{mode}"] = dict(cost=got["cost"], cost_single=cost1, cost_rel=rel,
                                       rotvec_max_abs=drot, X_max_abs=dX)
        k2 = [x["seg_sum"] for x in out["rank_launches"][f"ba_small_{mode}"]]
        log(f"[multigpu] ring_scene(8, 61) float64, {mode}-sharded over {MG_RANKS} ranks: "
            f"cost {got['cost']:.10g} against one rank's {cost1:.10g} (rel {rel:.2e}), "
            f"rotvec within {drot:.2e}, X within {dX:.2e}; K2 by rank {k2}")
        if not rel < 1e-6 or not drot < 1e-8:
            fail(f"[multigpu] {mode}-sharded float64 solve off the single one: cost rel "
                 f"{rel:.2e} (gate 1e-6), rotvec {drot:.2e} (gate 1e-8)")
        if min(k2) < 1:
            fail(f"[multigpu] {mode}-sharded: a rank did not launch K2")
    p, O = big_ba_problem(device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, costs1, acc1 = _big_ba_steps(p, ba.BAConfig(), BIG_BA_STEPS)
    torch.cuda.synchronize()
    out["ba_big_single_s"] = time.perf_counter() - t0
    # K1 and K2 at the sharded paths' shapes, against their plain versions
    out["shapes"] = multigpu_shapes(seg_sum, two_nn, p, dev)
    del p
    for mode in ("obs", "point"):
        got = [r[f"ba_big_{mode}"] for r in res]
        costs, acc = got[0]["costs"], got[0]["accepts"]
        rel = [abs(a - b) / b for a, b in zip(costs, costs1)]
        k2 = [x["seg_sum"] for x in out["rank_launches"][f"ba_big_{mode}"]]
        out[f"ba_big_{mode}"] = dict(obs=O, local_rows=[g["local_rows"] for g in got],
                                     costs=costs, costs_single=costs1, accepts=acc,
                                     accepts_single=acc1, cost_rel=rel,
                                     s=[g["s"] for g in got],
                                     peak_gib=[g["peak_gib"] for g in got])
        log(f"[multigpu] big_ba_problem (256 poses, 300,000 points, {O} observations, "
            f"float32), {mode}-sharded over {MG_RANKS} ranks: rows by rank "
            f"{[g['local_rows'] for g in got]}, costs {costs} against one rank's {costs1} "
            f"(rel {[f'{x:.2e}' for x in rel]}), accepts {acc} / {acc1}, K2 by rank {k2}, "
            f"{max(g['s'] for g in got):.1f} s against {out['ba_big_single_s']:.1f} s")
        # an accept near the float32 floor may flip, so the accepts are printed
        if not rel[0] < 1e-5 or not max(rel) < BIG_BA_COST_REL:
            fail(f"[multigpu] {mode}-sharded float32 steps off the single solve: cost rel "
                 f"{rel} (gates 1e-5 before the first step, {BIG_BA_COST_REL} after)")
        if min(k2) < 1:
            fail(f"[multigpu] big {mode}-sharded: a rank did not launch K2")

    # (c) the ring's file against the single rank's, K1 once a ring step
    with open(ring_out, "rb") as f1, open(os.path.join(md, "matches.putative.bin"), "rb") as f2:
        same = f1.read() == f2.read()
    k1 = [x["two_nn"] for x in out["rank_launches"]["ring"]]
    steps = [MG_RANKS - r for r in range(MG_RANKS)]
    out["ring"] = dict(byte_identical=same, k1_by_rank=k1, matched_steps=steps,
                       s=max(out["task_s"]["ring"]), rc=[r["ring"]["rc"] for r in res])
    log(f"[multigpu] matches --ring_matching on over {MG_RANKS} ranks: "
        f"{res[0]['ring']['stdout'].strip().splitlines()}; file byte-identical to the "
        f"single rank's: {same}; K1 launches by rank {k1} (blocks matched {steps})")
    if out["ring"]["rc"] != [0] * MG_RANKS or not same:
        fail("[multigpu] the ring's matches file differs from the single rank's")
    if k1 != steps:
        fail(f"[multigpu] K1 launches by rank {k1}, not one a matched ring step {steps}")

    # (d) scaling-bench over ranks sharing the card
    text = res[0]["scaling"]["stdout"]
    out["scaling"] = json.loads(text[text.index("{"):])
    log(f"[multigpu] scaling-bench -s 1,2,4 over {MG_RANKS} gloo ranks SHARING ONE CARD through "
        "the host (the harness's overheads, no multi-card scaling): "
        + json.dumps(out["scaling"]))
    if set(out["scaling"]["ba_point_sharded"]) != {"1", "2", "4"}:
        fail(f"[multigpu] scaling-bench sizes {list(out['scaling']['ba_point_sharded'])}")
    out["s"] = time.perf_counter() - t_all
    log(f"[multigpu] phase {out['s']:.1f} s")
    return out


def final_problem(scene):
    """The final bundle adjustment's problem, rebuilt from the scene it
    wrote (the polish after it changes no observation)."""
    import torch

    from openmvg_torch.sfm import ba

    prob, _ = ba.problem_from_scene(scene, refine_intrinsics=ba.ADJUST_ALL,
                                    dtype=torch.float32, device="cuda")
    return prob


def camera_bound_ms(O, P, I, kind, itemsize):
    """Least time for a fused camera sum: the J blocks (12 + 16 values a
    row), u (2 values, J^T u only) and both int32 id streams read once, the
    outputs written once; bytes bound it (a few flops a byte)."""
    per_row = (28 + (2 if kind == "jtu" else 0)) * itemsize + 8
    out = (P * 6 + I * 8) if kind == "jtu" else (P * 36 + I * 64)
    return (O * per_row + out * itemsize) / H100_BYTES * 1e3, "bytes"


def unfused_camera(seg_sum, kind, args, plans):
    """The sequence the fused call replaces: the products formed as
    (O, k) rows, then one generic K2 call a half."""
    jp, ji, u, pose, intr, P, I = args
    if kind == "jtu":
        return (seg_sum.seg_sum(seg_sum.brmatvec(jp, u), pose, P, plans[0]),
                seg_sum.seg_sum(seg_sum.brmatvec(ji, u), intr, I, plans[1]))
    return (seg_sum.seg_sum(seg_sum.outer_flat(jp), pose, P, plans[0]).reshape(P, 6, 6),
            seg_sum.seg_sum(seg_sum.outer_flat(ji), intr, I, plans[1]).reshape(I, 8, 8))


def phase_measure_k2(seg_sum, prob, tag="[measure]", profiled=True):
    """K2 at the main path's own shapes, the final INCREMENTAL bundle
    adjustment: the fused camera_jtu (u = -r, as the gradient) and
    camera_jtj on its Jacobians with the plans the BA uses, beside the
    unfused sequence; and the generic K2 on the (O, 6) J^T r and (O, 36)
    J^T J pose payloads, beside index_add_.  With `profiled` false no
    profiler session runs and the device time is not measured."""
    import torch

    from openmvg_torch.sfm import ba

    cfg = ba.BAConfig()
    p = ba.with_plans(prob)
    r, Jp6, Ji8, _ = ba.jacobians(p, cfg, ba.cam_fast_ok(p))
    P, I, O = p.rotvec.shape[0], p.intr_params.shape[0], Jp6.shape[0]
    plans = p.seg_plans
    args = (Jp6, Ji8, (-r).contiguous(), p.obs_pose, p.obs_intr, P, I)
    out = {}
    for kind in ("jtu", "jtj"):
        got = camera_call(seg_sum, kind, args, plans)
        again = camera_call(seg_sum, kind, args, plans)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{tag} camera_{kind} on the final BA: two launches differ")
        err = camera_check(seg_sum, kind, got, args, 1e-5)
        if err is None:
            fail(f"{tag} camera_{kind} on the final BA: outside 1e-5 (1 + S)")
        uf = unfused_camera(seg_sum, kind, args, plans)
        delta = max((a - b).abs().max().item() for a, b in zip(got, uf))
        ms = cuda_ms(lambda: camera_call(seg_sum, kind, args, plans), 50)
        dev_ms, n_k = (device_ms(lambda: camera_call(seg_sum, kind, args, plans), 50,
                                 "camera_sums_kernel") if profiled else (None, 0))
        unfused_ms = cuda_ms(lambda: unfused_camera(seg_sum, kind, args, plans), 50)
        plain_fn = seg_sum.camera_jtu_plain if kind == "jtu" else seg_sum.camera_jtj_plain
        pargs = args if kind == "jtu" else args[:2] + args[3:]
        plain_ms = cuda_ms(lambda: plain_fn(*pargs), 20)
        bound, by = camera_bound_ms(O, P, I, kind, Jp6.element_size())
        log(f"{tag} camera_{kind} on the final BA (O {O}, P {P}, I {I}, chunks "
            f"{plans[0].chunk_start.shape[0]} + {plans[1].chunk_start.shape[0]}): max |err| "
            f"{err:.3g}, repeatable, max |fused - unfused| {delta:.3g}; kernel {ms:.4f} ms "
            f"(device {fmt_ms(dev_ms)}, {n_k} launches in 50 calls), unfused sequence "
            f"{unfused_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}); "
            f"{bound / ms * 100:.2f}% of the bound")
        out[kind] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, unfused_ms=unfused_ms,
                         library_ms=None, bound_ms=bound, bound_by=by, max_abs_err=err,
                         fused_vs_unfused=delta, O=O, P=P, I=I)
    ids, num = p.obs_pose, P
    plan = plans[0]
    for name, vals in (("jtr_k6", ba._brmatvec(Jp6, -r).contiguous()),
                       ("jtj_k36", ba._outer_flat(Jp6).contiguous())):
        got = seg_sum.seg_sum(vals, ids, num, plan)
        torch.cuda.synchronize()
        err = seg_sum_check(seg_sum, got, vals, ids, num, 1e-5)
        if err is None:
            fail(f"{tag} seg_sum on the final BA's {name}: outside 1e-5 (1 + S)")
        ms = cuda_ms(lambda: seg_sum.seg_sum(vals, ids, num, plan), 50)
        dev_ms, _ = (device_ms(lambda: seg_sum.seg_sum(vals, ids, num, plan), 50,
                               "seg_sum_kernel") if profiled else (None, 0))
        plain_ms = cuda_ms(lambda: seg_sum.seg_sum_plain(vals, ids, num), 20)
        lib_ms = cuda_ms(lambda: library_seg_sum(vals, ids, num), 20)
        k = vals.shape[1]
        bound, by = seg_sum_bound_ms(O, k, num, vals.element_size())
        log(f"{tag} seg_sum {name} on the final BA (O {O}, k {k}, num {num}, "
            f"{int(plan.perm.shape[0])} valid rows): max |err| {err:.3g}; "
            f"kernel {ms:.4f} ms (device {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, "
            f"index_add_ {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}); "
            f"{bound / ms * 100:.2f}% of the bound")
        out[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound, bound_by=by, max_abs_err=err, O=O, k=k, num=num)
    return out


def smatvec_bound_ms(O, L1, L, M, P, I):
    """Least time for K3's work: the slot Jacobians (34 floats) and both
    ids read once a slot, the point blocks, row and group tables and v
    read once, (P, 6) and (I, 8) written once, against 68 multiply-adds a
    slot and 9 a point at the float32 rate outside the tensor cores."""
    nbytes = O * (34 * 4 + 2 * 4) + L * 9 * 4 + L1 * 4 + L * M * 4 + 2 * (P * 6 + I * 8) * 4
    t_bytes = nbytes / H100_BYTES
    t_ops = (O * 68 + L * 9) * 2 / H100_F32_FLOPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def smatvec_design_floor_ms(O, L, P, I):
    """Least time for K3's two-launch design, which reads the slot record
    twice (the pose sums cannot be taken in the point-owned pass without
    per-block (P, 14) partials or float atomics): launch 1 reads the record
    (144 B a slot), the point blocks and row offsets and writes e (8 B);
    launch 2 reads, through K2's plans, each slot's perm entry, Jp or Ji and
    e (60 + 76 B), and writes the outputs."""
    launch1 = O * (144 + 8) + L * (9 + 1) * 4
    launch2 = O * (60 + 76) + 2 * (P * 6 + I * 8) * 4
    return (launch1 + launch2) / H100_BYTES * 1e3


def unfused_matvec(ba, p, Jp6, Ji8, Jx3, Hpp_inv, vp, vi):
    """The port's unfused matvec core (sfm/ba.py::schur_cg_solve, S_matvec
    without the O(P) terms): the yardstick K3 replaces, about 12 small ops
    and one fused K2 call."""
    import torch

    n_pose, n_intr, n_pts = vp.shape[0], vi.shape[0], Hpp_inv.shape[0]
    u = ba._camera_matvec(vp, vi, p, Jp6, Ji8)
    y = torch.einsum("lij,lj->li", Hpp_inv, ba._pt_seg_sum(ba._brmatvec(Jx3, u), p, n_pts))
    return ba._camera_rmatvec(u - ba._bmatvec(Jx3, ba._pt_expand(y, p)), p, Jp6, Ji8,
                              n_pose, n_intr)


def k3_final_inputs(smatvec, prob):
    """K3's inputs at a bundle adjustment's own shapes: its Jacobians,
    damped point inverses (lam 1e-4), tables and K2 plans, with a random v.
    Returns (p, r, lam, cfg, args, plan)."""
    import torch

    from openmvg_torch.ops import linalg
    from openmvg_torch.sfm import ba

    cfg = ba.BAConfig()
    p = ba.with_plans(prob)
    r, Jp6, Ji8, Jx3 = ba.jacobians(p, cfg, ba.cam_fast_ok(p))
    P, I, L = p.rotvec.shape[0], p.intr_params.shape[0], p.X.shape[0]
    lam = torch.tensor(1e-4, dtype=torch.float32, device="cuda")
    eye3 = torch.eye(3, device="cuda")
    Hpp = ba._block_outer_pt(Jx3, p, L)
    dpp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hpp = (Hpp + lam * torch.clamp(dpp, min=1e-12)[..., None] * eye3
           + ((1.0 - p.mask_X) + 1e-12)[:, None, None] * eye3)
    Hinv = linalg.inv_sym3(Hpp)
    g = torch.Generator(device="cuda").manual_seed(4)
    vp = torch.randn((P, 6), generator=g, device="cuda")
    vi = torch.randn((I, 8), generator=g, device="cuda")
    t = p.pt_obs
    args = [Jp6, Ji8, Jx3, p.obs_pose, p.obs_intr, vp, vi, Hinv, t.row_point, t.groups]
    plan = smatvec.smatvec_plan(p.obs_pose, p.obs_intr, t.row_point, p.X.shape[0], P, I,
                                p.seg_plans)
    return p, r, lam, cfg, args, plan


def phase_measure_k3(smatvec, seg_sum, prob):
    """K3 at the final GLOBAL bundle adjustment's own shapes
    (k3_final_inputs); beside it the unfused matvec, and the launches of
    one damped solve each way (unfused 3 + C K2 launches, fused 3)."""
    import torch

    from openmvg_torch.sfm import ba

    p, r, lam, cfg, args, plan = k3_final_inputs(smatvec, prob)
    Jp6, Ji8, Jx3, vp, vi, Hinv, t = args[0], args[1], args[2], args[5], args[6], args[7], \
        p.pt_obs
    P, I, L = vp.shape[0], vi.shape[0], Hinv.shape[0]
    n0 = smatvec.LAUNCHES
    got = smatvec.smatvec(*args, plan=plan)
    per_call = smatvec.LAUNCHES - n0
    again = smatvec.smatvec(*args, plan=plan)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("smatvec on the final GLOBAL BA: two launches differ")
    err = smatvec_check(smatvec, got, args)
    if err is None:
        fail("smatvec on the final GLOBAL BA: outside 1e-5 (1 + S)")
    uf = unfused_matvec(ba, p, Jp6, Ji8, Jx3, Hinv, vp, vi)
    delta = max((a - b).abs().max().item() for a, b in zip(got, uf))
    delta_rel = delta / max(max(b.abs().max().item() for b in uf), 1e-30)
    ms = cuda_ms(lambda: smatvec.smatvec(*args, plan=plan), 50)
    dev_ms, n_k = device_ms(lambda: smatvec.smatvec(*args, plan=plan), 50, "smatvec")
    plain_ms = cuda_ms(lambda: smatvec.smatvec_plain(*args), 20)
    unfused_ms = cuda_ms(lambda: unfused_matvec(ba, p, Jp6, Ji8, Jx3, Hinv, vp, vi), 20)
    O, L1, M = Jp6.shape[0], t.row_point.shape[0], t.groups.shape[1]
    bound, by = smatvec_bound_ms(O, L1, L, M, P, I)
    floor = smatvec_design_floor_ms(O, L, P, I)
    log(f"[measure] smatvec on the final GLOBAL BA (O {O}, R {O // L1}, L1 {L1}, L {L}, "
        f"M {M}, P {P}, I {I}, {plan.tiles.shape[0]} tiles): max |err| {err:.3g}, "
        f"repeatable; kernel {ms:.4f} ms (device {fmt_ms(dev_ms)}, {n_k} launches in 50 "
        f"calls, {per_call} a call), plain {plain_ms:.4f} ms, unfused matvec "
        f"{unfused_ms:.4f} ms, bound {bound:.4f} ms ({by}), design floor {floor:.4f} ms; "
        f"{bound / ms * 100:.2f}% of the bound"
        + (f" by events, {bound / dev_ms * 100:.2f}% on the device" if dev_ms else "")
        + f"; max |fused - unfused| {delta:.3g} ({delta_rel:.3g} of the largest |output|)")

    counts = {}
    for mode, q in (("unfused", p._replace(k3_plan=None)), ("fused", p)):
        seg_sum.LAUNCHES = smatvec.LAUNCHES = 0
        ba.schur_cg_solve(q, r, Jp6, Ji8, Jx3, lam, cfg)
        torch.cuda.synchronize()
        counts[mode] = (seg_sum.LAUNCHES, smatvec.LAUNCHES)
    cg_unfused = counts["unfused"][0] - 3     # 3 + C: two J^T u, one J^T J, one a CG step
    cg_fused = counts["fused"][1] / per_call
    log(f"[measure] one damped solve: unfused {counts['unfused'][0]} K2 launches "
        f"(C = launches - 3 = {cg_unfused:g} CG iterations), fused {counts['fused'][0]} K2 "
        f"and {counts['fused'][1]} K3 launches ({cg_fused:g} calls of {per_call})")
    if counts["fused"][0] != 3 or abs(cg_fused - cg_unfused) > 1:
        fail("one damped solve breaks the launch rule (unfused 3 + C K2 launches; fused 3 "
             "K2 launches and C calls of K3)")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, unfused_ms=unfused_ms,
                bound_ms=bound, bound_by=by, design_floor_ms=floor, launches_per_call=per_call,
                max_abs_err=err, fused_vs_unfused=delta, fused_vs_unfused_rel=delta_rel,
                O=O, R=O // L1, L=L, M=M, P=P, I=I, cg_unfused=cg_unfused, cg_fused=cg_fused)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=100)
    ap.add_argument("--size", type=int, default=1024)
    args = ap.parse_args()
    t_all = time.perf_counter()
    smi, mhz = phase_device()

    import torch

    import openmvg_torch  # noqa: F401  (numeric policy: no TF32)
    from openmvg_torch.ops import seg_sum, smatvec, two_nn

    dev = torch.device("cuda")
    kernels = [dict(name="two_nn", module=two_nn, route="cuda",
                    source="openmvg_torch/csrc/two_nn.cu",
                    replaces="openmvg_tpu/ops/pallas_matching.py:62"),
               dict(name="seg_sum", module=seg_sum, route="cuda",
                    source="openmvg_torch/csrc/seg_sum.cu",
                    replaces="openmvg_tpu/ops/pallas_segsum.py:30"),
               dict(name="smatvec", module=smatvec, route="cuda",
                    source="openmvg_torch/csrc/smatvec.cu",
                    replaces="openmvg_tpu/ops/pallas_smatvec.py:85")]
    mods = [k["module"] for k in kernels]
    phase_build(kernels)
    kres = phase_kernel(two_nn, dev)
    k2_errs = phase_kernel_k2(seg_sum, dev)
    k3_err = phase_kernel_k3(smatvec, dev)
    k3_final = phase_k3_no_table_final(smatvec, seg_sum, dev)
    nmatch = native_match_check(two_nn, kres.pop("headline"), kres["headline_ms"])
    if args.views != 100 or args.size != 1024:
        log(f"[pipeline] CUT: {args.views} views of {args.size}^2 "
            "(the realistic scale is 100 views of 1024^2)")
    with tempfile.TemporaryDirectory(prefix="omt_torch_smoke_") as work:
        run = phase_pipeline(mods, args.views, args.size, work)
        srun = phase_sfm(mods, run, args.views, need=("seg_sum", "smatvec"))
        log(f"[sfm] K2 launches in the INCREMENTAL sfm stage: {srun['launches']['seg_sum']} "
            "(one a call)")
        nba = native_ba_check(srun["scene"])
        jrun = phase_jpeg(mods, run, args.views, args.size, mhz)
        cut_views = min(args.views, CUT_VIEWS)
        crun, cut_matches = (cut_run(run, cut_views, "sfm2 and stellar")
                             if cut_views < args.views else (run, "matches.f.bin"))
        v2run = phase_sfm2(mods, crun, cut_views, cut_matches)
        grun = phase_global(mods, run, args.views)
        strun = phase_stellar(mods, crun, cut_views, cut_matches)
        mrun = phase_matchers(mods, run, srun, args.views)
        trun = phase_tools(mods, run, srun, args.views)
        mgrun = phase_multigpu(mods, run, srun, trun)
        c3_views = min(args.views, 24)
        log(f"[camera3] CUT: {c3_views} views of {args.size}^2, "
            f"{c3_views * (c3_views - 1) // 2} exhaustive pairs (the realistic scale is "
            "100 views of 1024^2)")
        c3run = phase_camera3(mods, c3_views, args.size, os.path.join(work, "camera3"))
        drun = phase_describers(mods, run, dev)
        curun = phase_cubify(mods, work, dev)
        vorun = phase_vo(mods, work, dev)
        sprun = phase_spherical(mods, work, dev)
    meas = phase_measure(two_nn, run, dev, mhz, drun.pop("k1_inputs"))
    drun["AKAZE_FLOAT"]["k1_at_shape"]["device_ms"] = meas["akaze_float_device_ms"]
    m2 = phase_measure_k2(seg_sum, final_problem(srun["scene"]))
    m3 = phase_measure_k3(smatvec, seg_sum, final_problem(grun["scene"]))

    def new_paths(name):
        return {"launches_jpeg": jrun["launches"][name], "launches_v2": v2run["launches"][name],
                "launches_stellar": strun["launches"][name],
                "launches_camera3": c3run["launches"][name],
                "launches_tools": {k: v[name] for k, v in trun["launches_by_step"].items()}}

    def multigpu_launches(name):
        """Each multigpu run's launches, by rank (the NCCL world of one runs
        in this process)."""
        runs = {t: [x[name] for x in mgrun[t]["rank_launches"]]
                for t in ("refine_d4_nccl", "refine_d4_gloo")}
        runs.update({t: [x[name] for x in v] for t, v in mgrun["rank_launches"].items()})
        return runs

    def evals(r):
        return {k: v for k, v in r["stats"].items() if not isinstance(v, dict)}

    k2 = m2["jtu"]
    line = {"kernels": [{
        "name": "two_nn", "route": "cuda", "source": kernels[0]["source"],
        "replaces": kernels[0]["replaces"], "launches": run["launches"]["two_nn"],
        "max_abs_err": kres["u8_err"], "max_abs_err_f32": kres["f32_err"],
        "ms": meas["ms"], "device_ms": meas["device_ms"], "plain_ms": meas["plain_ms"],
        "bound_ms": meas["bound_ms"], "bound_by": meas["bound_by"],
        "library_ms": meas["library_ms"], "epilogue_floor_ms": meas["epilogue_floor_ms"],
        "cpu_baseline_ms": nmatch["ms"],
        "cpu_baseline": dict(nmatch, what="openmvg_torch.native.bench_match_2nn on the "
                             "headline 16 pairs, 1,024 A rows a pair planted (host CPU, "
                             "AVX2 + OpenMP)"),
        "max_sm_clock_mhz": mhz, "headline_16x4096": {"ms": kres["headline_ms"], "plain_ms": kres["headline_plain_ms"],
                             "library_ms": kres["headline_lib_ms"],
                             "bound_ms": kres["headline_bound_ms"]},
        **new_paths("two_nn"), "launches_matchers": mrun["launches_two_nn"],
        "known_poses_shape": mrun["known_poses"]["k1_at_shape"],
        "akaze_float_shape": drun["AKAZE_FLOAT"]["k1_at_shape"],
        "tools_shapes": {"bench_ann": trun["k1_at_bench_ann"]},
        "launches_multigpu": multigpu_launches("two_nn"),
        "multigpu_shapes": {"scaling_bench": mgrun["shapes"]["scaling_k1"]},
        "jpeg_shapes": {"matches_batch": {k: v for k, v in
                                          jrun["shapes"]["k1_matches_batch"].items()
                                          if k != "akaze_float_device_ms"}},
    }, {
        "name": "seg_sum", "route": "cuda", "source": kernels[1]["source"],
        "replaces": kernels[1]["replaces"], "launches": srun["launches"]["seg_sum"],
        "max_abs_err": k2["max_abs_err"], "max_abs_err_cases": k2_errs,
        "ms": k2["ms"], "device_ms": k2["device_ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": None,
        "cpu_baseline_ms": nba["ms"],
        "cpu_baseline": dict(nba, what="openmvg_torch.native.bench_ba_lm_step, one float64 LM "
                             "step at the final INCREMENTAL problem (host CPU, OpenMP)"),
        "unfused_ms": k2["unfused_ms"], "fused_vs_unfused_max_abs": k2["fused_vs_unfused"],
        "shape": {"O": k2["O"], "P": k2["P"], "I": k2["I"]}, "camera_jtj": m2["jtj"],
        "generic_jtr_k6": m2["jtr_k6"], "generic_jtj_k36": m2["jtj_k36"],
        "launches_global": grun["launches"]["seg_sum"], **new_paths("seg_sum"),
        "launches_vlad": mrun["launches_seg_sum_vlad"],
        "vlad_lloyd_shape": mrun["vlad"]["k2_lloyd_at_shape"],
        "tools_shapes": {"localize_camera_jtu": trun["k2_at_localize"]["jtu"],
                         "localize_camera_jtj": trun["k2_at_localize"]["jtj"],
                         "cluster_lloyd": trun["k2_at_cluster"]},
        "launches_spherical_incremental": sprun["INCREMENTAL"]["launches"]["seg_sum"],
        "launches_spherical_global": sprun["GLOBAL"]["launches"]["seg_sum"],
        "launches_multigpu": multigpu_launches("seg_sum"),
        "multigpu_shapes": {k: v for k, v in mgrun["shapes"].items() if k != "scaling_k1"},
        "jpeg_shapes": jrun["shapes"]["k2_final_ba"],
    }, {
        "name": "smatvec", "route": "cuda", "source": kernels[2]["source"],
        "replaces": kernels[2]["replaces"], "launches": grun["launches"]["smatvec"],
        "max_abs_err": m3["max_abs_err"], "max_abs_err_cases": k3_err,
        "ms": m3["ms"], "device_ms": m3["device_ms"], "plain_ms": m3["plain_ms"],
        "bound_ms": m3["bound_ms"], "bound_by": m3["bound_by"], "library_ms": None,
        "design_floor_ms": m3["design_floor_ms"],
        "launches_per_call": m3["launches_per_call"], "unfused_ms": m3["unfused_ms"],
        "fused_vs_unfused_max_abs": m3["fused_vs_unfused"],
        "fused_vs_unfused_rel": m3["fused_vs_unfused_rel"],
        "shape": {k: m3[k] for k in ("O", "R", "L", "M", "P", "I")},
        "cg_iterations_one_solve": {"unfused": m3["cg_unfused"], "fused": m3["cg_fused"]},
        "no_table_final_scale": k3_final,
        **new_paths("smatvec"),
        "launches_spherical_incremental": sprun["INCREMENTAL"]["launches"]["smatvec"],
        "launches_spherical_global": sprun["GLOBAL"]["launches"]["smatvec"],
        "launches_multigpu": multigpu_launches("smatvec"),
    }], "pipeline_s": run["secs"], "sfm_s": srun["secs"], "engine_s": srun["engine"],
        "polish_steps": srun["polish_steps"], "eval": evals(srun),
        "sfm2_s": v2run["secs"], "sfm2_engine_s": v2run["engine"],
        "sfm2_polish_steps": v2run["polish_steps"], "sfm2_eval": evals(v2run),
        "global_s": grun["secs"], "global_engine_s": grun["engine"],
        "global_polish_steps": grun["polish_steps"],
        "global_pairs_kept": grun["pairs_kept"], "global_eval": evals(grun),
        "jpeg": {k: v for k, v in jrun.items() if k not in ("launches", "shapes")},
        "sfm2_views": cut_views, "stellar_views": cut_views,
        "stellar_s": strun["secs"], "stellar_engine_s": strun["engine"],
        "stellar_pods": strun["pods"], "stellar_eval": evals(strun),
        "camera3_views": c3_views, "camera3_s": c3run["secs"],
        "camera3_pipeline_s": c3run["pipeline_s"], "camera3_engine_s": c3run["engine"],
        "camera3_polish_steps": c3run["polish_steps"], "camera3_k123": c3run["k123"],
        "camera3_peak_device_gib": c3run["peak_device_gib"], "camera3_eval": evals(c3run),
        "matchers": {k: v for k, v in mrun.items() if isinstance(v, dict)},
        "describers": {m: {k: v for k, v in r.items() if k != "k1_at_shape"}
                       for m, r in drun.items()},
        "spherical": sprun, "cubify": curun, "vo": vorun,
        "tools": {k: v for k, v in trun.items()
                  if k not in ("launches_by_step", "k2_at_localize", "k2_at_cluster",
                               "k1_at_bench_ann", "scene_bin")},
        "multigpu": {k: v for k, v in mgrun.items() if k not in ("rank_launches", "shapes")}}
    log(f"[done] {time.perf_counter() - t_all:.1f} s in all")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
