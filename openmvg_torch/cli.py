"""Command-line front end of the port — the openMVG_main_* binaries as
subcommands (counterpart: openmvg_tpu/cli.py, the stages of the
one-command pipeline and eval).

  init      main_SfMInit_ImageListing.cpp  (EXIF -> sfm_data.json)
  features  main_ComputeFeatures.cpp       (SIFT, presets; AKAZE_FLOAT, AKAZE_MLDB)
  pairs     main_PairGenerator.cpp         (EXHAUSTIVE | CONTIGUOUS)
  matches   main_ComputeMatches.cpp        (brute-force L2 on K1, cascade
                                            hashing, kd-tree; ratio 0.8)
  filter    main_GeometricFilter.cpp       (AC-RANSAC f|e|h|a|u|o, 4 px (o: 2),
                                            2048 it; -r guided matching)
  sfm       main_SfM.cpp                   (INCREMENTAL | INCREMENTALV2 | GLOBAL |
                                            STELLAR; sfm_data .json or .bin, the
                                            HTML report)
  color     main_ComputeSfM_DataColor.cpp  (colorized.ply)
  eval      main_evalQuality.cpp           (Strecha ground truth; --html)
  report    sfm_report.cpp                 (SfMReconstruction_Report.html)
  convert   main_ConvertSfM_DataFormat.cpp (.json | .bin | .xml, part flags)
  points-filter main_PointsFiltering.cpp   (depth cleaning)
  known-poses main_ComputeStructureFromKnownPoses.cpp
  vlad      main_ComputeVLAD.cpp           (retrieval pair list)
  kvld-filter matching/kvld                (K-VLD match verification)
  cubify    main_openMVGSpherical2Cubic.cpp (equirectangular -> 6 cube faces)
  vo        software/VO                    (FAST + KLT monocular odometry)
  pipeline  SfM_SequentialPipeline.py /    (init .. color in one command; GLOBAL
            SfM_GlobalPipeline.py           filters with e)
  export    software/SfM/export/*          (nvm colmap baf bundler pmvs mve openmvs
                                            agisoft meshlab mvstexturing cmpmvs
                                            frustums webgl undistorted json bin ply)
  localize  main_SfM_Localization.cpp      (query images in a reconstruction)
  cluster   main_ComputeClusters.cpp       (k-means of the camera centres)
  refine    Bundle_Adjustment_Ceres        (standalone BA of a scene; -d N shards it
                                            over N ranks, point blocks apart)
  geo-register registration_to_exif_gps_position.cpp (LMedS similarity)
  harmonize software/colorHarmonize        (per-image gain and offset; PNG)
  frustum-filter, change-origin, list-pairs, convert-matches, matches2tracks,
  split-matches, export-keypoints, export-matches, export-tracks,
  retrieval-quality, bench-ann: the small tools of software/SfM and
  software/Localization, as in the reference
  scaling-bench                            (the sharded paths' overhead over
                                            mesh prefixes of the world)

Several ranks (parallel/runtime.py): refine -d N starts its own ranks, one
a card over NCCL, or N sharing the cards with OMT_DIST_BACKEND=gloo (always
gloo with --device cpu).  matches and scaling-bench run on every rank of
the world they are launched in (torchrun, the OMT_COORDINATOR /
OMT_NUM_PROCESSES / OMT_PROCESS_ID variables, or runtime.spawn of
runtime.run_cli); rank 0 writes and prints.

--profile DIR (before the subcommand), or OMT_PROFILE_DIR, records the
command under torch.profiler and writes a Chrome trace into DIR, which
holds the program's spans (utils/logging: the stages, and each bundle
adjustment's ba.adjust, ba.lm_step, its phases and host reads); the
session's counters are logged in one line as it ends.  A missing input
file prints "error: file not found: <name>" and returns 1.

Flags, defaults and printed summaries are the reference's, plus --device:
every stage runs on `cuda` unless `--device cpu` is given, and raises when
CUDA is asked for and absent.  Stages exchange the reference's files
(sfm_data.json / .bin / .xml, .feat/.desc, matches.*.bin), so the two
packages' stages can be mixed.

    python -m openmvg_torch.cli init -i images -o out -f 1228.8 -c 1
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from openmvg_torch.utils.device import resolve_device

FEATURE_BATCH = 8  # same-shape images per SIFT call


def cmd_init(args):
    from openmvg_torch.io.image import (focal_from_exif, load_sensor_database,
                                        read_exif)
    from openmvg_torch.io.sfm_data import save_sfm_data
    from openmvg_torch.models import cameras as cm
    from openmvg_torch.sfm.scene import Scene

    exts = (".jpg", ".jpeg", ".png", ".tif", ".tiff")
    files = sorted(f for f in os.listdir(args.imageDirectory)
                   if f.lower().endswith(exts))
    if not files:
        print("no images found", file=sys.stderr)
        return 1
    db = load_sensor_database(args.sensorWidthDatabase)
    scene = Scene(root_path=os.path.abspath(args.imageDirectory))
    kinds, widths, heights, params, intr_of_view = [], [], [], [], []
    group_key = {}
    for f in files:
        exif = read_exif(os.path.join(args.imageDirectory, f))
        w, h = exif["width"], exif["height"]
        focal = args.focal or focal_from_exif(exif, db)
        if focal is None:
            focal = 1.2 * max(w, h)  # the reference's fallback heuristic
        key = ((w, h, round(focal, 2), exif.get("model", ""))
               if args.group_camera_model else f)
        if key not in group_key:
            group_key[key] = len(kinds)
            kinds.append(args.camera_model)
            widths.append(float(w))
            heights.append(float(h))
            p = np.zeros(cm.MAX_PARAMS)
            p[0:3] = [focal, w / 2.0, h / 2.0]
            params.append(p)
        intr_of_view.append(group_key[key])
        scene.view_filename.append(f)
        if args.use_pose_prior:
            gps = exif.get("gps")
            if gps and "lat" in gps and "lon" in gps:
                from openmvg_torch.geometry.geodesy import lla_to_ecef

                if scene.prior_center is None:
                    scene.prior_center = np.zeros((len(files), 3))
                    scene.prior_center_weight = np.zeros((len(files), 3))
                v = len(scene.view_filename) - 1
                scene.prior_center[v] = np.asarray(lla_to_ecef(
                    gps["lat"], gps["lon"], gps.get("alt", 0.0)))
                try:
                    pw = [float(x) for x in args.prior_weights.split(";")]
                except ValueError:
                    pw = []
                if len(pw) != 3:
                    print(f"-W/--prior_weights must be 3 ';'-separated "
                          f"floats (got {args.prior_weights!r})",
                          file=sys.stderr)
                    return 1
                scene.prior_center_weight[v] = pw
    n = len(files)
    scene.view_intrinsic = np.asarray(intr_of_view, np.int32)
    scene.view_pose = np.arange(n, dtype=np.int32)
    scene.view_wh = np.asarray(
        [[widths[i], heights[i]] for i in intr_of_view], np.int32)
    scene.cameras = cm.Cameras(kind=np.asarray(kinds, np.int32),
                               width=np.asarray(widths),
                               height=np.asarray(heights),
                               params=np.stack(params))
    scene.pose_valid = np.zeros(n, bool)
    scene.pose_R = np.tile(np.eye(3), (n, 1, 1))
    scene.pose_C = np.zeros((n, 3))
    os.makedirs(args.outputDirectory, exist_ok=True)
    save_sfm_data(scene, os.path.join(args.outputDirectory, "sfm_data.json"))
    print(f"listed {n} views, {len(kinds)} intrinsic group(s)")
    return 0


def _write_image_describer_json(args):
    """image_describer.json (main_ComputeFeatures.cpp:168-230, cereal JSON):
    the describer and regions type, so that later tools recover it."""
    method = args.describerMethod.upper()
    preset_peak = {"NORMAL": 0.04, "HIGH": 0.01, "ULTRA": 0.01}
    if method.startswith("AKAZE"):
        dname = ("AKAZE_Image_describer_SURF" if "FLOAT" in method
                 else "AKAZE_Image_describer_MLDB")
        rname = "AKAZE_Float_Regions" if "FLOAT" in method else "AKAZE_Binary_Regions"
        params = {"options": {"iNbOctave": 4, "iNbSlicePerOctave": 4,
                              "fThreshold": 0.0016, "fDesc_factor": 1.0}}
    else:
        dname = ("SIFT_Anatomy_Image_describer" if method == "SIFT_ANATOMY"
                 else "SIFT_Image_describer")
        rname = "SIFT_Regions"
        params = {"first_octave": -1 if args.describerPreset.upper() == "ULTRA" else 0,
                  "num_octaves": 6, "num_scales": 3, "edge_threshold": 10.0,
                  "peak_threshold": preset_peak.get(args.describerPreset.upper(), 0.04),
                  "root_sift": True}
    doc = {
        "image_describer": {
            "polymorphic_id": 2147483649,
            "polymorphic_name": dname,
            "ptr_wrapper": {"id": 2147483649,
                            "data": {"params": params,
                                     "bOrientation": not args.upright}},
        },
        "regions_type": {
            "polymorphic_id": 2147483650,
            "polymorphic_name": rname,
            "ptr_wrapper": {"id": 2147483650, "data": {"value0": 0}},
        },
    }
    with open(os.path.join(args.outdir, "image_describer.json"), "w") as f:
        json.dump(doc, f, indent=2)


def cmd_features(args):
    from openmvg_torch.io.features_io import save_descs, save_feats
    from openmvg_torch.io.image import read_image
    from openmvg_torch.sfm.describer import _check_method, describe_images_batch

    _check_method(args.describerMethod)
    scene = _load_scene(args.input_file)
    os.makedirs(args.outdir, exist_ok=True)
    _write_image_describer_json(args)
    t0 = time.time()
    batch = []

    def flush():
        if not batch:
            return
        results = describe_images_batch(
            [b[3] for b in batch], args.describerMethod, args.describerPreset,
            upright=args.upright, device=args.device)
        for (featp, descp, name, _), (feats, descs) in zip(batch, results):
            save_feats(featp, feats)
            save_descs(descp, descs)
            print(f"  {name}: {len(feats)} features")
        batch.clear()

    for name in scene.view_filename:
        stem = os.path.splitext(os.path.basename(name))[0]
        featp = os.path.join(args.outdir, stem + ".feat")
        descp = os.path.join(args.outdir, stem + ".desc")
        if not args.force and os.path.exists(featp) and os.path.exists(descp):
            continue
        img = read_image(os.path.join(scene.root_path, name), grayscale=True)
        if batch and img.shape != batch[0][3].shape:
            flush()
        batch.append((featp, descp, name, img))
        if len(batch) >= FEATURE_BATCH:
            flush()
    flush()
    print(f"features done in {time.time() - t0:.1f}s")
    return 0


def cmd_pairs(args):
    from openmvg_torch.utils.graph import contiguous_pairs, exhaustive_pairs

    scene = _load_scene(args.input_file)
    n = scene.n_views
    pairs = (contiguous_pairs(n, args.contiguous_count)
             if args.pair_mode.upper() == "CONTIGUOUS" else exhaustive_pairs(n))
    _write_pairs(args.output_file, pairs)
    print(f"{len(pairs)} pairs")
    return 0


def _write_pairs(path, pairs):
    with open(path, "w") as f:
        for i, j in pairs:
            f.write(f"{i} {j}\n")


def load_pairs_file(path):
    pairs = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                pairs.append((int(parts[0]), int(parts[1])))
    return pairs


def _load_scene(path):
    from openmvg_torch.io.sfm_data import load_sfm_data

    return load_sfm_data(path)


def _load_features_for_scene(scene, matchdir):
    from openmvg_torch.io.features_io import load_descs, load_feats

    feats, descs = [], []
    for name in scene.view_filename:
        stem = os.path.splitext(os.path.basename(name))[0]
        feats.append(load_feats(os.path.join(matchdir, stem + ".feat")))
        descs.append(load_descs(os.path.join(matchdir, stem + ".desc")))
    return feats, descs


def matcher_of(name):
    """-n value -> the matcher of ops.matching.match_descriptor_lists, as the
    reference maps it (any other name is brute force)."""
    name = name.upper()
    if name in ("FASTCASCADEHASHINGL2", "CASCADEHASHINGL2"):
        return "cascade"
    return "kdtree" if name in ("ANNL2", "KDTREE") else "bruteforce"


def cmd_matches(args):
    from openmvg_torch.io.matches_io import save_matches
    from openmvg_torch.ops import matching
    from openmvg_torch.utils.graph import exhaustive_pairs

    from openmvg_torch.parallel import runtime

    rank, world = runtime.launched_world(args.device)
    scene = _load_scene(args.input_file)
    matchdir = args.matchdir or os.path.dirname(args.output_file)
    feats, descs = _load_features_for_scene(scene, matchdir)
    pairs = (load_pairs_file(args.pair_list) if args.pair_list
             else exhaustive_pairs(scene.n_views))
    kw = dict(method=matcher_of(args.nearest_matching_method))
    # the reference's rule: ring-stream brute force over more than one rank,
    # with auto when the descriptor stack would pass 1 GiB on each rank
    row_bytes = max((np.asarray(d)[:1].nbytes for d in descs), default=0)
    stack_bytes = len(descs) * max((len(d) for d in descs), default=0) * row_bytes
    use_ring = kw["method"] == "bruteforce" and world > 1 and (
        args.ring_matching == "on" or (args.ring_matching == "auto" and stack_bytes > 1 << 30))
    if world > 1 and not use_ring and rank != 0:
        return 0                 # rank 0 matches the whole list alone
    run_pairs = (lambda d, pl: _ring_matches(d, pl, args.ratio)) if use_ring else \
        (lambda d, pl: matching.match_descriptor_lists(d, pl, args.ratio, args.device, **kw))
    if kw["method"] == "cascade":
        # the port's own hyperplanes (seed 0) and view 0's descriptor mean
        kw["proj"] = matching.make_hash_projections(0, device=args.device)
        d0 = np.asarray(descs[0]) if len(descs[0]) else np.zeros((1, 128), np.uint8)
        kw["mean"] = torch.as_tensor(d0.mean(0).astype(np.float32), device=args.device)
    t0 = time.time()
    if args.preemptive_count:
        # preemptive pair pruning (main_ComputeMatches.cpp:55-57,185-187,328):
        # match the k largest-scale features, keep pairs above 8% of k
        k = args.preemptive_count
        sub = [matching.preemptive_subset(feats[v], descs[v], k)[1]
               for v in range(scene.n_views)]
        pre = run_pairs(sub, pairs)
        thr = 0.08 * k
        pairs = [pq for pq, m in pre.items() if len(m) >= thr] if pre is not None else None
        if use_ring:
            pairs = _from_rank0(pairs)
        if rank == 0:
            print(f"preemptive: kept {len(pairs)} pairs "
                  f"(>= {thr:.0f} of {k} feats matched)")
    out = run_pairs(descs, pairs)
    if rank != 0:
        return 0
    if use_ring:
        print(f"ring matching over {world} ranks")
    save_matches(out, args.output_file)
    n_m = sum(len(m) for m in out.values())
    print(f"{len(out)} matched pairs, {n_m} putative matches "
          f"in {time.time() - t0:.1f}s")
    return 0


def _ring_matches(descs, pairs, ratio):
    """Brute-force matches of `pairs` ring-streamed over every rank of the
    world (parallel/ring_matching.py): {(i, j): (M, 2)} on rank 0, None on
    the others."""
    from openmvg_torch.ops import matching
    from openmvg_torch.parallel import runtime
    from openmvg_torch.parallel.ring_matching import ring_match_pairs

    stack, counts = matching.descriptor_stack(descs, "cpu")
    pair_ij = np.asarray(pairs, np.int64).reshape(-1, 2)
    res = ring_match_pairs(stack, counts, pair_ij, runtime.global_mesh(), ratio)
    return None if res is None else matching.matches_to_dict(pair_ij, res)


def _from_rank0(obj):
    """Rank 0's `obj` on every rank."""
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def cmd_filter(args):
    from openmvg_torch.io.matches_io import load_matches, save_matches
    from openmvg_torch.sfm.geometric_filter import geometric_filter

    scene = _load_scene(args.input_file)
    feats, descs = _load_features_for_scene(scene, os.path.dirname(args.matches))
    putative = load_matches(args.matches)
    t0 = time.time()
    # per-model default threshold inside geometric_filter (4.0 px; 2.0 for o)
    filtered = geometric_filter(
        scene, feats, putative, model=args.geometric_model,
        n_samples=args.max_iteration, guided=args.guided_matching, descs=descs,
        device=args.device)
    save_matches(filtered, args.output_file)
    n_m = sum(len(m) for m in filtered.values())
    print(f"{len(filtered)}/{len(putative)} pairs kept, {n_m} matches "
          f"in {time.time() - t0:.1f}s")
    return 0


def cmd_sfm(args):
    from openmvg_torch.io.matches_io import load_matches
    from openmvg_torch.io.ply import save_scene_ply
    from openmvg_torch.io.sfm_data import save_sfm_data
    from openmvg_torch.sfm import ba
    from openmvg_torch.sfm.scene import rmse
    from openmvg_torch.utils.logging import (format_stage_times, reset_stage_times,
                                             stage_times)
    from openmvg_torch.utils.report import generate_sfm_report

    engine = args.sfm_engine.upper()
    if engine not in ("INCREMENTAL", "INCREMENTALV2", "GLOBAL", "STELLAR"):
        print(f"engine {engine} not available", file=sys.stderr)
        return 1
    scene = _load_scene(args.input_file)
    feats, _ = _load_features_for_scene(scene, args.match_dir)
    matches = load_matches(args.match_file or os.path.join(args.match_dir, "matches.f.bin"))
    os.makedirs(args.output_dir, exist_ok=True)
    t0 = time.time()
    refine = ba.ADJUST_ALL if args.refine_intrinsic_config == "ADJUST_ALL" else ba.ADJUST_NONE
    reset_stage_times()
    # stats: the accepted f64 polish steps and `rounds`; for GLOBAL and
    # STELLAR the final BA's runs (one plus one per rejector pass)
    stats = {}
    if engine == "GLOBAL":
        from openmvg_torch.sfm.pipeline_global import GlobalConfig, global_sfm

        cfg = GlobalConfig(verbose=True, refine_intrinsics=refine,
                           rotation_averaging=args.rotationAveraging,
                           translation_averaging=args.translationAveraging)
        global_sfm(scene, feats, matches, cfg, device=args.device, stats=stats)
    elif engine == "STELLAR":
        from openmvg_torch.sfm.pipeline_stellar import StellarConfig, stellar_sfm

        cfg = StellarConfig(verbose=True, refine_intrinsics=refine)
        stellar_sfm(scene, feats, matches, cfg, device=args.device, stats=stats)
    else:
        from openmvg_torch.sfm.pipeline_incremental import IncrementalConfig, incremental_sfm

        initial_pair = None
        if args.initial_pair_a and args.initial_pair_b:
            names = [os.path.basename(n) for n in scene.view_filename]
            initial_pair = (names.index(os.path.basename(args.initial_pair_a)),
                            names.index(os.path.basename(args.initial_pair_b)))
        cfg = IncrementalConfig(verbose=True, refine_intrinsics=refine,
                                initializer=args.sfm_initializer, initial_pair=initial_pair,
                                engine_version=2 if engine == "INCREMENTALV2" else 1)
        incremental_sfm(scene, feats, matches, cfg, device=args.device, stats=stats)
    out_name = "sfm_data.bin" if args.output_format == "bin" else "sfm_data.json"
    save_sfm_data(scene, os.path.join(args.output_dir, out_name))
    save_scene_ply(scene, os.path.join(args.output_dir, "cloud_and_poses.ply"))
    generate_sfm_report(scene, os.path.join(args.output_dir, "SfMReconstruction_Report.html"))
    print(f"SfM done in {time.time() - t0:.1f}s: {int(scene.pose_valid.sum())} poses, "
          f"{scene.n_landmarks} points, rmse={rmse(scene):.3f}px, "
          f"{stats['polish_steps']} f64 polish steps, {stats['rounds']} rounds"
          + (f", {stats['pods']} pods" if "pods" in stats else ""))
    print("stage seconds:\n" + format_stage_times(stage_times))
    return 0


def cmd_color(args):
    from openmvg_torch.io.ply import save_ply
    from openmvg_torch.sfm.colorize import colorize

    scene = _load_scene(args.input_file)
    colors = colorize(scene)
    save_ply(args.output_file, scene.X[scene.X_valid], colors[scene.X_valid],
             camera_centers=scene.pose_C[scene.pose_valid])
    print(f"colorized {int(scene.X_valid.sum())} points")
    return 0


def cmd_eval(args):
    from openmvg_torch.io.gt_loaders import load_strecha_gt
    from openmvg_torch.sfm.eval_quality import evaluate_against_gt

    stats = evaluate_against_gt(_load_scene(args.input_file), load_strecha_gt(args.gt_dir))
    if args.html:
        from openmvg_torch.sfm.eval_quality import export_eval_html

        export_eval_html(stats, args.html)
    print(json.dumps({k: v for k, v in stats.items() if not isinstance(v, dict)}, indent=2))
    return 0


def cmd_report(args):
    from openmvg_torch.utils.report import generate_sfm_report

    generate_sfm_report(_load_scene(args.input_file), args.output_file)
    print(f"report written to {args.output_file}")
    return 0


def cmd_convert(args):
    """main_ConvertSfM_DataFormat.cpp: save again in the format of the
    output's extension, with the parts selected (all when none is)."""
    from openmvg_torch.io import sfm_data as sio

    parts = 0
    for flag, bit in (("views", sio.VIEWS), ("intrinsics", sio.INTRINSICS),
                      ("extrinsics", sio.EXTRINSICS), ("structure", sio.STRUCTURE),
                      ("control_points", sio.CONTROL_POINTS)):
        if getattr(args, flag):
            parts |= bit
    sio.save_sfm_data(sio.load_sfm_data(args.input_file), args.output_file, parts or sio.ALL)
    print(f"converted to {args.output_file}")
    return 0


def cmd_points_filter(args):
    """main_PointsFiltering.cpp: depth cleaning at `factor` times each
    view's median depth, then the structure renumbered."""
    from openmvg_torch.io.sfm_data import save_sfm_data
    from openmvg_torch.sfm.filters import depth_cleaning

    scene = _load_scene(args.input_file)
    min_median = depth_cleaning(scene, k_factor=args.factor)
    scene.compact_structure()
    save_sfm_data(scene, args.output_file)
    print(f"min median depth = {min_median}; {scene.n_landmarks} landmarks kept")
    return 0


def cmd_known_poses(args):
    """main_ComputeStructureFromKnownPoses: guided matching of every posed
    pair (K1 on the card), tracks and triangulation."""
    from openmvg_torch.io.sfm_data import save_sfm_data
    from openmvg_torch.sfm.known_poses import structure_from_known_poses
    from openmvg_torch.sfm.scene import rmse

    scene = _load_scene(args.input_file)
    feats, descs = _load_features_for_scene(scene, args.match_dir)
    structure_from_known_poses(scene, feats, descs, device=args.device)
    save_sfm_data(scene, args.output_file)
    print(f"structure: {scene.n_landmarks} landmarks, rmse={rmse(scene):.3f}")
    return 0


def cmd_vlad(args):
    """main_ComputeVLAD: a retrieval pair list from VLAD embeddings over a
    k-means codebook of the pooled descriptors (sums on K2 on the card)."""
    from openmvg_torch.ops import vlad

    scene = _load_scene(args.input_file)
    _, descs = _load_features_for_scene(scene, args.match_dir)
    pooled = np.concatenate([d[:500] for d in descs if len(d)])
    centers = vlad.build_codebook(torch.Generator().manual_seed(0), pooled,
                                  k=args.codebook_size, device=args.device)
    vlads = vlad.vlad_embeddings(descs, centers, device=args.device).cpu().numpy()
    pairs = vlad.retrieve_pairs(vlads, top_k=args.top_k)
    _write_pairs(args.output_file, pairs)
    print(f"{len(pairs)} retrieval pairs")
    return 0


def cmd_kvld_filter(args):
    """K-VLD photometric match verification of putative matches
    (matching/kvld): per pair, keep the matches with >= K consistent
    neighbours; the VLD differences run on the device."""
    from openmvg_torch.io.image import read_image
    from openmvg_torch.io.matches_io import load_matches, save_matches
    from openmvg_torch.ops.kvld import kvld_filter

    scene = _load_scene(args.input_file)
    matchdir = args.matchdir or os.path.dirname(args.matches)
    feats, _ = _load_features_for_scene(scene, matchdir)
    putative = load_matches(args.matches)
    images = {}

    def img_of(v):
        if v not in images:
            images[v] = np.asarray(read_image(
                os.path.join(scene.root_path, scene.view_filename[v]),
                grayscale=True), np.float64) * 255.0
        return images[v]

    def side(f):
        return dict(xy=f[:, :2], scale=f[:, 2], orientation=f[:, 3])

    out = {}
    t0 = time.time()
    for (i, j), m in sorted(putative.items()):
        kept, _, valid = kvld_filter(img_of(i), img_of(j), side(feats[i]), side(feats[j]), m,
                                     K=args.K, device=args.device)
        if len(kept):
            out[(i, j)] = kept
        print(f"  ({i},{j}): {int(valid.sum())}/{len(m)} kept")
    save_matches(out, args.output_file)
    print(f"kvld: {len(out)}/{len(putative)} pairs kept "
          f"in {time.time() - t0:.1f}s")
    return 0


def cmd_cubify(args):
    """main_openMVGSpherical2Cubic: every equirectangular view of the scene
    -> six cubemap pinhole faces, <stem>_face<k>.png, resampled on the
    device (the sampled values truncated to uint8, as the reference
    writes them)."""
    from openmvg_torch.io.image import read_image, write_image
    from openmvg_torch.ops.spherical import spherical_to_cubic

    scene = _load_scene(args.input_file)
    os.makedirs(args.output_dir, exist_ok=True)
    for name in scene.view_filename:
        pano = read_image(os.path.join(scene.root_path, name))
        faces, _, focal = spherical_to_cubic(torch.as_tensor(pano, device=args.device))
        faces = faces.to(torch.uint8).cpu().numpy()
        stem = os.path.splitext(os.path.basename(name))[0]
        for fidx in range(6):
            write_image(os.path.join(args.output_dir, f"{stem}_face{fidx}.png"), faces[fidx])
        print(f"{name}: 6 faces (focal={focal})")
    return 0


def cmd_vo(args):
    """Monocular visual odometry over an image sequence (software/VO: FAST
    + KLT tracking on the device, 5-point relative pose); writes the
    up-to-scale camera trajectory as text, one 'x y z' a frame."""
    from openmvg_torch.io.image import read_image
    from openmvg_torch.sfm.vo import MonocularVO

    exts = (".jpg", ".jpeg", ".png", ".tif", ".tiff")
    files = sorted(f for f in os.listdir(args.imageDirectory) if f.lower().endswith(exts))
    if not files:
        print("no images found", file=sys.stderr)
        return 1
    first = read_image(os.path.join(args.imageDirectory, files[0]), grayscale=True)
    h, w = first.shape
    f = args.focal or 1.2 * max(w, h)
    K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]])
    vo = MonocularVO(K, fast_threshold=args.threshold, device=args.device)
    vo.process(first)
    for name in files[1:]:
        vo.process(read_image(os.path.join(args.imageDirectory, name), grayscale=True))
        print(f"  {name}: {len(vo.trajectory)} poses")
    with open(args.output_file, "w") as fo:
        for C in vo.trajectory:
            fo.write(f"{C[0]} {C[1]} {C[2]}\n")
    print(f"trajectory of {len(vo.trajectory)} frames -> {args.output_file}")
    return 0


def cmd_pipeline(args):
    """init -> features -> pairs -> matches -> filter -> sfm -> color in one
    command (SfM_SequentialPipeline.py, SfM_GlobalPipeline.py), each stage on
    args.device; GLOBAL filters with the essential model, every other engine
    with the fundamental one."""
    out = args.output_dir
    matches_dir = os.path.join(out, "matches")
    is_global = args.sfm_engine.upper() == "GLOBAL"
    recon_dir = os.path.join(out, "reconstruction_global" if is_global
                             else "reconstruction_sequential")
    os.makedirs(matches_dir, exist_ok=True)
    sfm_json = os.path.join(out, "sfm_data.json")
    stages = [
        ["init", "-i", args.imageDirectory, "-o", out]
        + (["-f", str(args.focal)] if args.focal else []) + ["-c", str(args.camera_model)],
        ["features", "-i", sfm_json, "-o", matches_dir, "-m", args.describerMethod,
         "-p", args.describerPreset],
        ["pairs", "-i", sfm_json, "-o", os.path.join(matches_dir, "pairs.txt")],
        ["matches", "-i", sfm_json, "-o", os.path.join(matches_dir, "matches.putative.bin"),
         "-p", os.path.join(matches_dir, "pairs.txt"), "-r", str(args.ratio)],
        ["filter", "-i", sfm_json, "-m", os.path.join(matches_dir, "matches.putative.bin"),
         "-o", os.path.join(matches_dir, "matches.f.bin"), "-g", "e" if is_global else "f"],
        ["sfm", "-i", sfm_json, "-m", matches_dir,
         "-M", os.path.join(matches_dir, "matches.f.bin"), "-o", recon_dir,
         "-s", args.sfm_engine],
        ["color", "-i", os.path.join(recon_dir, "sfm_data.json"),
         "-o", os.path.join(recon_dir, "colorized.ply")],
    ]
    for st in stages:
        print(f"=== openmvg_torch {' '.join(st)}")
        rc = main(st + ["--device", str(args.device)])
        if rc != 0:
            print(f"pipeline stage {st[0]} failed", file=sys.stderr)
            return rc
    print(f"pipeline complete -> {recon_dir}")
    return 0


def cmd_export(args):
    """The scene in one of the formats of software/SfM/export/."""
    from openmvg_torch.io import exporters
    from openmvg_torch.io.sfm_data import save_sfm_data

    scene = _load_scene(args.input_file)
    fmt = args.format.lower()
    writers = dict(nvm=exporters.export_nvm, colmap=exporters.export_colmap,
                   baf=exporters.export_baf, bundler=exporters.export_bundler,
                   pmvs=exporters.export_pmvs, mve=exporters.export_mve,
                   openmvs=exporters.export_openmvs, agisoft=exporters.export_agisoft,
                   meshlab=exporters.export_meshlab,
                   mvstexturing=exporters.export_mvstexturing,
                   cmpmvs=exporters.export_cmpmvs, frustums=exporters.export_frustums_ply,
                   webgl=exporters.export_webgl)
    if fmt in ("json", "bin"):
        save_sfm_data(scene, args.output_file)
    elif fmt == "ply":
        from openmvg_torch.io.ply import save_scene_ply

        save_scene_ply(scene, args.output_file)
    elif fmt == "undistorted":
        exporters.export_undistorted_images(scene, args.output_file, device=args.device)
    elif fmt in writers:
        writers[fmt](scene, args.output_file)
    else:
        print(f"unknown format {fmt}", file=sys.stderr)
        return 1
    print(f"exported {fmt}")
    return 0


def cmd_localize(args):
    """main_SfM_Localization: each query image's SIFT features matched
    against the scene's landmark database and its pose found by AC-RANSAC
    resection and a pose-only BA, on the device.  The scene's first view's
    intrinsic (model and distortion included) is the queries' camera."""
    from openmvg_torch.io.image import read_image
    from openmvg_torch.models import cameras as cm
    from openmvg_torch.sfm import localization as loc
    from openmvg_torch.sfm.describer import describe_image

    scene = _load_scene(args.input_file)
    _, descs = _load_features_for_scene(scene, args.match_dir)
    db = loc.build_landmark_database(scene, descs)
    iid = int(scene.view_intrinsic[0])
    prm = np.asarray(scene.cameras.params)[iid]
    kind = int(scene.cameras.kind[iid])
    K = cm.K_matrix_np(prm)
    w, h = float(scene.cameras.width[iid]), float(scene.cameras.height[iid])
    t0, n_found = time.time(), 0
    for q in args.query_images:
        qf, qd = describe_image(read_image(q, grayscale=True), device=args.device)
        res = loc.localize_image(db, qf, qd, K, w, h, kind=kind,
                                 disto_params=prm[3:cm.N_PARAMS[kind]], device=args.device)
        if res.found:
            n_found += 1
            print(f"{q}: localized with {res.n_inliers} inliers, C = {res.C.tolist()}")
        else:
            print(f"{q}: localization FAILED")
    print(f"localized {n_found}/{len(args.query_images)} queries in {time.time() - t0:.1f}s")
    return 0


def cmd_cluster(args):
    """main_ComputeClusters: the posed views split into overlapping
    clusters, one sub-scene file each (k-means on the device)."""
    from openmvg_torch.io.sfm_data import save_sfm_data
    from openmvg_torch.sfm.clustering import cluster_views, scene_for_views

    scene = _load_scene(args.input_file)
    clusters = cluster_views(scene, args.n_clusters, device=args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    for k, views in enumerate(clusters):
        save_sfm_data(scene_for_views(scene, views),
                      os.path.join(args.output_dir, f"sfm_data_cluster_{k}.json"))
        print(f"cluster {k}: {len(views)} views")
    return 0


def cmd_frustum_filter(args):
    """main_FrustumFiltering.cpp: the posed pairs whose frusta intersect."""
    from openmvg_torch.geometry.frustum import frustum_filter_pairs
    from openmvg_torch.utils.graph import exhaustive_pairs

    scene = _load_scene(args.input_file)
    posed = set(scene.valid_view_poses().tolist())
    cand = [(i, j) for (i, j) in exhaustive_pairs(scene.n_views) if i in posed and j in posed]
    pairs = frustum_filter_pairs(scene, cand, z_near=args.z_near, z_far=args.z_far)
    _write_pairs(args.output_file, pairs)
    print(f"{len(pairs)}/{len(cand)} pairs kept")
    return 0


def cmd_change_origin(args):
    """main_ChangeLocalOrigin.cpp: the scene translated to a local origin
    (the first posed camera with -f, else -l 'x;y;z')."""
    from openmvg_torch.io.sfm_data import save_sfm_data

    scene = _load_scene(args.input_file)
    if args.first_frame_origin:
        posed = [p for p in range(scene.n_poses) if scene.pose_valid[p]]
        if not posed:
            print("scene has no poses", file=sys.stderr)
            return 1
        origin = scene.pose_C[posed[0]].copy()
    else:
        vals = args.local_frame_origin.split(";")
        if len(vals) != 3:
            print("origin must be 'x;y;z'", file=sys.stderr)
            return 1
        origin = np.array([float(v) for v in vals])
    scene.pose_C = scene.pose_C - origin
    if len(scene.X):
        scene.X = scene.X - origin
    if len(scene.cp_X):
        scene.cp_X = scene.cp_X - origin
    if scene.prior_center is not None:
        scene.prior_center = scene.prior_center - origin
    os.makedirs(args.output_directory, exist_ok=True)
    save_sfm_data(scene, os.path.join(args.output_directory, "sfm_data_local.bin"))
    with open(os.path.join(args.output_directory, "local_frame_origin.txt"), "w") as f:
        f.write(f"{origin[0]} {origin[1]} {origin[2]}\n")
    print(f"origin {origin} subtracted")
    return 0


def cmd_list_pairs(args):
    """main_ListMatchingPairs.cpp: exhaustive, video (-V, -d) or GPS (-G,
    the -n nearest prior centres) pairs."""
    from openmvg_torch.utils.graph import contiguous_pairs, exhaustive_pairs

    scene = _load_scene(args.input_file)
    n = scene.n_views
    if args.video_mode:
        pairs = contiguous_pairs(n, args.video_distance)
    elif args.gps_mode:
        centers = np.full((n, 3), np.nan)
        if scene.prior_center is not None:
            centers = np.asarray(scene.prior_center, float)
        pairs = []
        for i in range(n):
            if np.any(np.isnan(centers[i])):
                continue
            near = np.argsort(np.linalg.norm(centers - centers[i], axis=1))
            kept = [int(j) for j in near
                    if j != i and not np.any(np.isnan(centers[j]))][:args.gps_neighbor]
            pairs += [(min(i, j), max(i, j)) for j in kept]
        pairs = sorted(set(pairs))
    else:
        pairs = exhaustive_pairs(n)
    _write_pairs(args.output_file, pairs)
    print(f"{len(pairs)} pairs")
    return 0


def cmd_convert_matches(args):
    """main_ConvertMatches.cpp: matches .bin <-> .txt by extension; -a the
    adjacency matrix as SVG (ui/ImageGraphViewer)."""
    from openmvg_torch.io.matches_io import load_matches, save_matches

    matches = load_matches(args.input_file)
    save_matches(matches, args.output_file)
    if args.adjacency_svg:
        from openmvg_torch.utils.report import svg_adjacency_matrix

        n = 1 + max((max(i, j) for (i, j) in matches), default=0)
        svg_adjacency_matrix(n, matches, args.adjacency_svg)
        print(f"adjacency matrix -> {args.adjacency_svg}")
    print(f"converted {args.input_file} -> {args.output_file}")
    return 0


def cmd_matches_to_tracks(args):
    """main_MatchesToTracks.cpp: matches fused into tracks; prints their
    counts and writes 'track view feature' rows with -o."""
    from openmvg_torch.io.matches_io import load_matches
    from openmvg_torch.sfm.tracks import build_tracks

    tracks = build_tracks(load_matches(args.input_file))
    lengths = np.bincount(tracks.track_id)
    stats = {
        "n_tracks": int(tracks.track_id.max()) + 1 if len(tracks.track_id) else 0,
        "n_observations": len(tracks.track_id),
        "mean_length": float(lengths[lengths > 0].mean()) if len(lengths) else 0,
    }
    if args.output_file:
        with open(args.output_file, "w") as f:
            for t, v, ft in zip(tracks.track_id, tracks.view_id, tracks.feat_id):
                f.write(f"{t} {v} {ft}\n")
    print(json.dumps(stats))
    return 0


def cmd_split_matches(args):
    """main_SplitMatchFileIntoMatchFiles.cpp: one matches file per
    connected component of at least -n views (<out>_<k><ext>)."""
    from openmvg_torch.io.matches_io import load_matches, save_matches
    from openmvg_torch.sfm.clustering import split_matches_by_component

    parts = split_matches_by_component(load_matches(args.input_file), args.min_nodes)
    base, ext = os.path.splitext(args.output_file)
    for k, sub in enumerate(parts):
        save_matches(sub, f"{base}_{k}{ext}")
    print(f"{len(parts)} match files written")
    return 0


def ann_sift_descriptors(rng, n, device):
    """bench-ann's SIFT source: (base, query) float32 descriptors of a
    textured 512 x 512 image and of its warp by a 10 degree rotation and
    1.1 scale, at most n each."""
    from openmvg_torch.ops import image_ops
    from openmvg_torch.sfm.describer import describe_image

    img = np.zeros((512, 512), np.float32)
    for period in (4, 8, 16, 32):
        coarse = rng.random((512 // period + 2, 512 // period + 2))
        img += np.kron(coarse, np.ones((period, period)))[:512, :512]
    img = ((img - img.min()) / np.ptp(img)).astype(np.float32)
    a = np.radians(10.0)
    H = np.eye(3)
    H[:2, :2] = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]) * 1.1
    H[:2, 2] = 256 - H[:2, :2] @ [256, 256]
    warped = image_ops.warp_homography(torch.as_tensor(img, device=device), H).cpu().numpy()
    _, base = describe_image(img, preset="HIGH", max_features=n, device=device)
    _, query = describe_image(warped.astype(np.float32), preset="HIGH", max_features=n,
                              device=device)
    return base.astype(np.float32), query.astype(np.float32)


def cmd_bench_ann(args):
    """main_benchANN.cpp: recall and time of the cascade-hashing matcher
    against exact brute force (K1 on the card).  --source synthetic: noisy
    copies of uniform descriptors (recall also against the planted
    identity); --source sift: SIFT of a textured image and of a rotated,
    scaled warp of it.  --sweep: the curve over n in (1024, 4096, 16384)
    and top_c in (8, 16, 32)."""
    from openmvg_torch.ops import matching as mt

    dev = args.device
    rng = np.random.default_rng(0)
    n, d = args.n_descriptors, 128
    if args.source == "sift":
        base, query = ann_sift_descriptors(rng, n, dev)
        n = len(query)
    else:
        base = rng.integers(0, 255, (n, d)).astype(np.float32)
        noise = rng.normal(0, args.noise, (n, d)).astype(np.float32)
        query = np.clip(base + noise, 0, 255)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def to_set(res):
        ok = res.mask.cpu().numpy()
        return {(int(a), int(b)) for a, b in zip(res.idx_a.cpu().numpy()[ok],
                                                 res.idx_b.cpu().numpy()[ok])}

    t0 = time.time()
    bf_set = to_set(mt.match_brute_force(t(query), t(base), ratio=args.ratio))
    t_bf = time.time() - t0
    proj = mt.make_hash_projections(0, device=dev)
    t0 = time.time()
    ch_set = to_set(mt.match_cascade(t(query), t(base), proj, t(base.mean(0)),
                                     ratio=args.ratio))
    t_ch = time.time() - t0
    out = {
        "source": args.source,
        "n_query": int(n),
        "bruteforce": {"time_s": t_bf, "n": len(bf_set)},
        "cascade": {"time_s": t_ch, "n": len(ch_set),
                    "recall_vs_bruteforce": len(bf_set & ch_set) / max(len(bf_set), 1)},
    }
    if args.source != "sift":
        gt = {(i, i) for i in range(n)}
        out["bruteforce"]["recall"] = len(bf_set & gt) / n
        out["cascade"]["recall"] = len(ch_set & gt) / n
    if args.sweep:
        sweep = []
        for n_sw in (1024, 4096, 16384):
            if args.source == "sift":
                if n_sw > len(base):
                    continue
                b_sw, q_sw = base[:n_sw], query[:n_sw]
            else:
                b_sw = rng.integers(0, 255, (n_sw, d)).astype(np.float32)
                q_sw = np.clip(b_sw + rng.normal(0, args.noise, (n_sw, d)),
                               0, 255).astype(np.float32)
            bf = to_set(mt.match_brute_force(t(q_sw), t(b_sw), ratio=args.ratio))
            for top_c in (8, 16, 32):
                t0 = time.time()
                ch = to_set(mt.match_cascade(t(q_sw), t(b_sw), proj, t(b_sw.mean(0)),
                                             ratio=args.ratio, top_c=top_c))
                sweep.append({"n": int(n_sw), "top_c": int(top_c),
                              "recall_vs_bruteforce": len(bf & ch) / max(len(bf), 1),
                              "time_s": round(time.time() - t0, 4)})
        out["sweep"] = sweep
        out["backend"] = dev.type
        if args.sweep_out:
            with open(args.sweep_out, "w") as f:
                json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    return 0


def _refine_rank(rank, n, path, refine, iterations):
    """One rank of refine -d N: the scene's problem on the host, this rank's
    point block on its device, the point-sharded LM loop.  Returns the
    final cost, the rank's kernel launches and, on rank 0, the solved
    parameters."""
    from openmvg_torch.parallel import dist_ba, runtime
    from openmvg_torch.parallel.mesh import make_mesh
    from openmvg_torch.sfm import ba
    from openmvg_torch.utils.logging import stage

    before = runtime.kernel_launches()
    prob, _ = ba.problem_from_scene(_load_scene(path), refine_intrinsics=refine)
    with stage("bundle_adjustment"):
        out, cost = dist_ba.adjust_point_sharded(prob, make_mesh(n),
                                                 ba.BAConfig(max_iterations=iterations))
    launches = {k: v - before[k] for k, v in runtime.kernel_launches().items()}
    params = {f: getattr(out, f).cpu() for f in ("rotvec", "t", "intr_params", "X")}
    return dict(cost=cost, launches=launches, params=params if rank == 0 else None)


def cmd_refine(args):
    """Standalone bundle adjustment of an existing reconstruction
    (Schur-CG LM, camera sums on K2; on the card a float32 solve takes
    the CG matvec through K3).  -d N > 1 shards it by point blocks over N
    ranks (parallel/dist_ba.py; K3 off), one a card over NCCL, so at most the
    card count, or N sharing the cards over gloo with OMT_DIST_BACKEND=gloo
    or --device cpu; each rank's kernel launches are printed."""
    from openmvg_torch.io.ply import save_scene_ply
    from openmvg_torch.io.sfm_data import save_sfm_data
    from openmvg_torch.sfm import ba
    from openmvg_torch.sfm.scene import rmse
    from openmvg_torch.utils.logging import stage

    scene = _load_scene(args.input_file)
    refine = ba.ADJUST_ALL if args.refine_intrinsic_config == "ADJUST_ALL" else ba.ADJUST_NONE
    t0 = time.time()
    if args.devices > 1:
        from openmvg_torch.parallel import runtime

        n, backend = runtime.ranks_for(args.devices, args.device)
        if n < args.devices:
            print(f"refine -d {args.devices}: {torch.cuda.device_count()} CUDA card(s) and "
                  f"one NCCL rank a card, so {n} rank(s) (OMT_DIST_BACKEND=gloo shares them)")
        res = runtime.run_ranks(_refine_rank, n, args.device, backend,
                                (args.input_file, refine, args.iterations))
        prob, maps = ba.problem_from_scene(scene, refine_intrinsics=refine)
        prob, cost = prob._replace(**res[0]["params"]), res[0]["cost"]
        print(f"distributed BA over {n} devices: cost={cost:.4f}")
        for r, rr in enumerate(res):
            print(f"  rank {r} ({backend}) kernel launches: {json.dumps(rr['launches'])}")
    else:
        prob, maps = ba.problem_from_scene(scene, refine_intrinsics=refine, device=args.device)
        with stage("bundle_adjustment"):
            prob, cost, _ = ba.adjust(prob, ba.BAConfig(max_iterations=args.iterations))
        print(f"BA: cost={cost:.4f}")
    ba.scene_from_problem(scene, prob, maps)
    os.makedirs(os.path.dirname(os.path.abspath(args.output_file)), exist_ok=True)
    save_sfm_data(scene, args.output_file)
    if args.ply:
        save_scene_ply(scene, args.ply)
    print(f"refined in {time.time() - t0:.1f}s: rmse={rmse(scene):.3f}px")
    return 0


def cmd_geo_register(args):
    """Registration onto GPS positions (registration_to_exif_gps_position.cpp):
    the scene's priors (--use_priors) or each view's EXIF GPS (PIL) in
    ECEF, an LMedS similarity fitted on the device, the scene transformed."""
    from openmvg_torch.io.ply import save_scene_ply
    from openmvg_torch.io.sfm_data import save_sfm_data
    from openmvg_torch.sfm import gps_registration as gr

    scene = _load_scene(args.input_file)
    if args.use_priors:
        scene, sim = gr.register_to_gps(scene, use_priors_from_scene=True, device=args.device)
    else:
        from openmvg_torch.geometry.geodesy import lla_to_ecef
        from openmvg_torch.io.image import read_exif

        views, positions = [], []
        for v in range(scene.n_views):
            gps = read_exif(os.path.join(scene.root_path, scene.view_filename[v])).get("gps")
            if gps and "lat" in gps and "lon" in gps:
                views.append(v)
                positions.append(np.asarray(lla_to_ecef(gps["lat"], gps["lon"],
                                                        gps.get("alt", 0.0))))
        if len(views) < 3:
            print(f"only {len(views)} views with EXIF GPS (need >= 3)", file=sys.stderr)
            return 1
        pids = scene.view_pose[np.asarray(views)]
        ok = (pids >= 0) & scene.pose_valid[np.clip(pids, 0, None)]
        if int(ok.sum()) < 3:
            print(f"only {int(ok.sum())} GPS views have reconstructed poses (need >= 3)",
                  file=sys.stderr)
            return 1
        sim = gr.fit_similarity_lmeds(scene.pose_C[pids[ok]], np.asarray(positions)[ok],
                                      device=args.device)
        scene = gr.apply_similarity_to_scene(scene, sim)
    save_sfm_data(scene, args.output_file)
    if args.ply:
        save_scene_ply(scene, args.ply)
    print(f"registered (scale={float(np.asarray(sim.scale)):.6g}) -> {args.output_file}")
    return 0


def cmd_export_keypoints(args):
    """export/main_exportKeypoints.cpp: one keypoint SVG per view."""
    from openmvg_torch.utils.report import svg_features

    scene = _load_scene(args.input_file)
    feats, _ = _load_features_for_scene(scene, args.matchdir)
    os.makedirs(args.outputDirectory, exist_ok=True)
    for v in range(scene.n_views):
        stem = os.path.splitext(os.path.basename(scene.view_filename[v]))[0]
        svg_features(tuple(scene.view_wh[v]), feats[v],
                     os.path.join(args.outputDirectory, stem + ".svg"))
    print(f"{scene.n_views} keypoint SVGs -> {args.outputDirectory}")
    return 0


def cmd_export_matches(args):
    """export/main_exportMatches.cpp: one side-by-side match SVG per pair."""
    from openmvg_torch.io.matches_io import load_matches
    from openmvg_torch.utils.report import svg_matches

    scene = _load_scene(args.input_file)
    feats, _ = _load_features_for_scene(scene, args.matchdir or os.path.dirname(args.matches))
    matches = load_matches(args.matches)
    os.makedirs(args.outputDirectory, exist_ok=True)
    for (i, j), m in sorted(matches.items()):
        svg_matches(tuple(scene.view_wh[i]), tuple(scene.view_wh[j]), feats[i], feats[j],
                    np.asarray(m), os.path.join(args.outputDirectory, f"{i:05d}_{j:05d}.svg"))
    print(f"{len(matches)} match SVGs -> {args.outputDirectory}")
    return 0


def cmd_export_tracks(args):
    """export/main_exportTracks.cpp: one SVG per pair of the matches that
    fuse into one track, coloured by track."""
    from openmvg_torch.io.matches_io import load_matches
    from openmvg_torch.sfm.tracks import build_tracks
    from openmvg_torch.utils.report import svg_tracks

    scene = _load_scene(args.input_file)
    feats, _ = _load_features_for_scene(scene, args.matchdir or os.path.dirname(args.matches))
    matches = load_matches(args.matches)
    tracks = build_tracks(matches, min_length=2)
    by_view = {}
    for tid, v, f in zip(tracks.track_id, tracks.view_id, tracks.feat_id):
        by_view.setdefault(int(v), {})[int(f)] = int(tid)
    os.makedirs(args.outputDirectory, exist_ok=True)
    n_svg = 0
    for (i, j), m in sorted(matches.items()):
        rows = []
        for fa, fb in np.asarray(m):
            tid = by_view.get(i, {}).get(int(fa))
            if tid is not None and by_view.get(j, {}).get(int(fb)) == tid:
                rows.append((int(fa), int(fb)))
        if not rows:
            continue
        svg_tracks(tuple(scene.view_wh[i]), tuple(scene.view_wh[j]), feats[i], feats[j], rows,
                   os.path.join(args.outputDirectory, f"{i:05d}_{j:05d}.svg"))
        n_svg += 1
    print(f"{n_svg} track SVGs ({tracks.n_tracks} tracks) -> {args.outputDirectory}")
    return 0


def cmd_harmonize(args):
    """software/colorHarmonize: per image and channel a gain and offset
    such that the colour quantiles at matched keypoints agree over every
    matched pair (IRLS-L1 on the reference's 10-quantile constraints), the
    reference view (-r, or the best-connected) pinned to (1, 0); the
    harmonised copies are written through the port's image writer (PNG
    without PIL)."""
    from openmvg_torch.io.image import read_image, write_image
    from openmvg_torch.io.matches_io import load_matches
    from openmvg_torch.sfm import color_harmonization as ch

    scene = _load_scene(args.input_file)
    feats, _ = _load_features_for_scene(scene, args.matchdir or os.path.dirname(args.matches))
    matches = load_matches(args.matches)
    if not matches:
        print("no matches", file=sys.stderr)
        return 1
    images = {}

    def img_of(v):
        if v not in images:
            im = np.asarray(read_image(os.path.join(scene.root_path, scene.view_filename[v])),
                            np.float64)
            if im.ndim == 2:
                im = im[..., None].repeat(3, -1)
            images[v] = im / 255.0
        return images[v]

    def samples(v, rows):
        im = img_of(v)
        h, w = im.shape[:2]
        xy = feats[v][rows, :2]
        return im[np.clip(xy[:, 1].astype(int), 0, h - 1), np.clip(xy[:, 0].astype(int), 0, w - 1)]

    n = scene.n_views
    counts = np.zeros(n)
    for (i, j), m in matches.items():
        counts[i] += len(m)
        counts[j] += len(m)
    ref = int(np.argmax(counts)) if args.reference < 0 else args.reference
    if not 0 <= ref < n:
        print(f"--reference view id {ref} out of range [0, {n})", file=sys.stderr)
        return 1
    gains, offsets = np.ones((n, 3)), np.zeros((n, 3))
    for c in range(3):
        pair_data = {(i, j): ch.pair_quantiles(samples(i, m[:, 0])[:, c], samples(j, m[:, 1])[:, c])
                     for (i, j), m in matches.items() if len(m) >= 4}
        gains[:, c], offsets[:, c] = ch.solve_gain_offset(n, pair_data, ref_image=ref)
    os.makedirs(args.outputDirectory, exist_ok=True)
    for v in range(n):
        im = np.clip(img_of(v) * gains[v] + offsets[v], 0.0, 1.0)
        write_image(os.path.join(args.outputDirectory, os.path.basename(scene.view_filename[v])),
                    (im * 255.0 + 0.5).astype(np.uint8))
        print(f"  {scene.view_filename[v]}: gain={gains[v].round(3)} "
              f"offset={offsets[v].round(3)}")
    print(f"harmonized {n} images (reference view {ref}) -> {args.outputDirectory}")
    return 0


def cmd_retrieval_quality(args):
    """main_MatchingRetrievalQuality.cpp: recall and precision of a pair
    list against ground-truth pairs (a matches file, or the scene's
    landmark co-visibility)."""
    gt_pairs = set()
    if args.gt_matches:
        from openmvg_torch.io.matches_io import load_matches

        gt_pairs = {(min(i, j), max(i, j)) for (i, j) in load_matches(args.gt_matches)}
    else:
        scene = _load_scene(args.input_file)
        ok = scene.obs_valid & scene.X_valid[scene.obs_landmark]
        by_lm = {}
        for idx in np.nonzero(ok)[0]:
            by_lm.setdefault(int(scene.obs_landmark[idx]), set()).add(int(scene.obs_view[idx]))
        for views in by_lm.values():
            vs = sorted(views)
            gt_pairs.update((vs[a], vs[b]) for a in range(len(vs)) for b in range(a + 1, len(vs)))
    putative = {(min(i, j), max(i, j)) for i, j in load_pairs_file(args.pair_file)}
    tp = len(gt_pairs & putative)
    fn = len(gt_pairs) - tp
    fp = len(putative) - tp
    print(json.dumps({
        "gt_pairs": len(gt_pairs), "putative_pairs": len(putative),
        "true_positive": tp, "false_negative": fn, "false_positive": fp,
        "recall": tp / max(tp + fn, 1), "precision": tp / max(tp + fp, 1),
    }, indent=1))
    return 0


def cmd_scaling_bench(args):
    """The scaling harness over mesh prefixes of the world this command was
    launched in (parallel/scaling_bench.measure_weak_scaling); sizes beyond
    the world are skipped, and rank 0 prints the JSON.  Ranks sharing one
    card give the harness's overheads, not multi-card scaling."""
    from openmvg_torch.parallel import runtime
    from openmvg_torch.parallel.scaling_bench import measure_weak_scaling

    sizes = tuple(int(s) for s in args.mesh_sizes.split(","))
    with runtime.joined(args.device) as (rank, _):
        res = measure_weak_scaling(mesh_sizes=sizes, pairs_per_device=args.pairs_per_device,
                                   n_feats=args.n_feats, trials=args.trials)
    if rank == 0:
        print(json.dumps(res, indent=1))
    return 0


def build_parser():
    ap = argparse.ArgumentParser(prog="openmvg_torch",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="",
                    help="directory for a torch.profiler trace of the command, "
                         "with the program's spans (stages, bundle adjustment phases)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def stage(name, fn):
        p = sub.add_parser(name)
        p.add_argument("--device", default=None,
                       help="torch device to run on (default cuda; no "
                            "fall-back to the CPU)")
        p.set_defaults(fn=fn)
        return p

    p = stage("init", cmd_init)
    p.add_argument("-i", "--imageDirectory", required=True)
    p.add_argument("-o", "--outputDirectory", required=True)
    p.add_argument("-d", "--sensorWidthDatabase", default=None)
    p.add_argument("-f", "--focal", type=float, default=None)
    p.add_argument("-c", "--camera_model", type=int, default=3)
    p.add_argument("-g", "--group_camera_model", type=int, default=1)
    p.add_argument("-P", "--use_pose_prior", action="store_true")
    p.add_argument("-W", "--prior_weights", default="1.0;1.0;1.0")

    p = stage("features", cmd_features)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-o", "--outdir", required=True)
    p.add_argument("-m", "--describerMethod", default="SIFT")
    p.add_argument("-p", "--describerPreset", default="NORMAL")
    p.add_argument("-u", "--upright", action="store_true")
    p.add_argument("-f", "--force", action="store_true")

    p = stage("pairs", cmd_pairs)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-o", "--output_file", required=True)
    p.add_argument("-m", "--pair_mode", default="EXHAUSTIVE")
    p.add_argument("-c", "--contiguous_count", type=int, default=5)

    p = stage("matches", cmd_matches)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-o", "--output_file", required=True)
    p.add_argument("-p", "--pair_list", default=None)
    p.add_argument("-d", "--matchdir", default=None)
    p.add_argument("-r", "--ratio", type=float, default=0.8)
    p.add_argument("-n", "--nearest_matching_method", default="AUTO")
    p.add_argument("-P", "--preemptive_count", type=int, default=0)
    p.add_argument("--ring_matching", choices=("auto", "on", "off"),
                   default="auto",
                   help="stream descriptor shards around the ranks instead of "
                        "holding the stack whole (several ranks only; auto = when "
                        "the stack exceeds 1 GiB)")

    p = stage("filter", cmd_filter)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-m", "--matches", required=True)
    p.add_argument("-o", "--output_file", required=True)
    p.add_argument("-g", "--geometric_model", default="f",
                   choices=["f", "e", "h", "a", "u", "o"])
    p.add_argument("-r", "--guided_matching", action="store_true")
    p.add_argument("--max_iteration", type=int, default=2048)

    p = stage("sfm", cmd_sfm)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-m", "--match_dir", required=True)
    p.add_argument("-M", "--match_file", default=None)
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("-s", "--sfm_engine", default="INCREMENTAL")
    p.add_argument("-f", "--refine_intrinsic_config", default="ADJUST_ALL")
    p.add_argument("-a", "--initial_pair_a", default="")
    p.add_argument("-b", "--initial_pair_b", default="")
    p.add_argument("-S", "--sfm_initializer", default="AUTO_PAIR")
    p.add_argument("-R", "--rotationAveraging", type=int, default=2)
    p.add_argument("-T", "--translationAveraging", type=int, default=3)
    p.add_argument("--output_format", default="json")

    p = stage("color", cmd_color)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-o", "--output_file", required=True)

    p = stage("eval", cmd_eval)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-g", "--gt_dir", required=True)
    p.add_argument("--html", default="")

    p = stage("report", cmd_report)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-o", "--output_file", required=True)

    p = stage("convert", cmd_convert)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-o", "--output_file", required=True)
    p.add_argument("-V", "--views", action="store_true")
    p.add_argument("-I", "--intrinsics", action="store_true")
    p.add_argument("-E", "--extrinsics", action="store_true")
    p.add_argument("-S", "--structure", action="store_true")
    p.add_argument("-C", "--control_points", action="store_true")

    p = stage("points-filter", cmd_points_filter)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-o", "--output_file", required=True)
    p.add_argument("-f", "--factor", type=float, default=5.2)

    p = stage("known-poses", cmd_known_poses)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-m", "--match_dir", required=True)
    p.add_argument("-o", "--output_file", required=True)

    p = stage("vlad", cmd_vlad)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-m", "--match_dir", required=True)
    p.add_argument("-o", "--output_file", required=True)
    p.add_argument("-k", "--codebook_size", type=int, default=64)
    p.add_argument("-t", "--top_k", type=int, default=10)

    p = stage("kvld-filter", cmd_kvld_filter)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-m", "--matches", required=True)
    p.add_argument("-o", "--output_file", required=True)
    p.add_argument("-d", "--matchdir", default=None)
    p.add_argument("-K", type=int, default=3)

    p = stage("cubify", cmd_cubify)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-o", "--output_dir", required=True)

    p = stage("vo", cmd_vo)
    p.add_argument("-i", "--imageDirectory", required=True)
    p.add_argument("-o", "--output_file", required=True)
    p.add_argument("-f", "--focal", type=float, default=0.0)
    p.add_argument("-t", "--threshold", type=float, default=0.06)

    p = stage("pipeline", cmd_pipeline)
    p.add_argument("-i", "--imageDirectory", required=True)
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("-s", "--sfm_engine", default="INCREMENTAL")
    p.add_argument("-f", "--focal", type=float, default=0.0)
    p.add_argument("-c", "--camera_model", type=int, default=3)
    p.add_argument("-m", "--describerMethod", default="SIFT")
    p.add_argument("-p", "--describerPreset", default="NORMAL")
    p.add_argument("-r", "--ratio", type=float, default=0.8)

    p = stage("export", cmd_export)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-o", "--output_file", required=True)
    p.add_argument("-f", "--format", required=True)

    p = stage("localize", cmd_localize)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-m", "--match_dir", required=True)
    p.add_argument("-q", "--query_images", nargs="+", required=True)

    p = stage("cluster", cmd_cluster)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("-n", "--n_clusters", type=int, default=2)

    p = stage("frustum-filter", cmd_frustum_filter)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-o", "--output_file", required=True)
    p.add_argument("-n", "--z_near", type=float, default=0.01)
    p.add_argument("-f", "--z_far", type=float, default=100.0)

    p = stage("change-origin", cmd_change_origin)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-o", "--output_directory", required=True)
    p.add_argument("-l", "--local_frame_origin", default="")
    p.add_argument("-f", "--first_frame_origin", action="store_true")

    p = stage("list-pairs", cmd_list_pairs)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-o", "--output_file", required=True)
    p.add_argument("-V", "--video_mode", action="store_true")
    p.add_argument("-G", "--gps_mode", action="store_true")
    p.add_argument("-d", "--video_distance", type=int, default=1)
    p.add_argument("-n", "--gps_neighbor", type=int, default=5)

    p = stage("convert-matches", cmd_convert_matches)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-o", "--output_file", required=True)
    p.add_argument("-a", "--adjacency_svg", default=None)

    p = stage("matches2tracks", cmd_matches_to_tracks)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-o", "--output_file", default="")

    p = stage("split-matches", cmd_split_matches)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-o", "--output_file", required=True)
    p.add_argument("-n", "--min_nodes", type=int, default=3)

    p = stage("bench-ann", cmd_bench_ann)
    p.add_argument("-n", "--n_descriptors", type=int, default=4096)
    p.add_argument("-r", "--ratio", type=float, default=0.8)
    p.add_argument("--noise", type=float, default=4.0)
    p.add_argument("--source", choices=["synthetic", "sift"], default="synthetic")
    p.add_argument("--sweep", action="store_true",
                   help="record the recall curve over N x top_c")
    p.add_argument("--sweep_out", default=None, help="write the sweep JSON here")

    p = stage("refine", cmd_refine)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-o", "--output_file", required=True)
    p.add_argument("-n", "--iterations", type=int, default=30)
    p.add_argument("-d", "--devices", type=int, default=1)
    p.add_argument("-f", "--refine_intrinsic_config", default="ADJUST_ALL")
    p.add_argument("--ply", default="")

    p = stage("geo-register", cmd_geo_register)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-o", "--output_file", required=True)
    p.add_argument("--use_priors", action="store_true",
                   help="use the GPS priors stored in the scene instead of EXIF")
    p.add_argument("--ply", default=None)

    p = stage("export-keypoints", cmd_export_keypoints)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-d", "--matchdir", required=True)
    p.add_argument("-o", "--outputDirectory", required=True)

    for name, fn in (("export-matches", cmd_export_matches),
                     ("export-tracks", cmd_export_tracks)):
        p = stage(name, fn)
        p.add_argument("-i", "--input_file", required=True)
        p.add_argument("-m", "--matches", required=True)
        p.add_argument("-d", "--matchdir", default=None)
        p.add_argument("-o", "--outputDirectory", required=True)

    p = stage("harmonize", cmd_harmonize)
    p.add_argument("-i", "--input_file", required=True)
    p.add_argument("-m", "--matches", required=True)
    p.add_argument("-d", "--matchdir", default=None)
    p.add_argument("-o", "--outputDirectory", required=True)
    p.add_argument("-r", "--reference", type=int, default=-1,
                   help="reference view id (-1 = best-connected)")

    p = stage("retrieval-quality", cmd_retrieval_quality)
    p.add_argument("-i", "--input_file", default="")
    p.add_argument("-p", "--pair_file", required=True)
    p.add_argument("-g", "--gt_matches", default="")

    p = stage("scaling-bench", cmd_scaling_bench)
    p.add_argument("-n", "--n_views", type=int, default=8)
    p.add_argument("-s", "--mesh_sizes", default="1,2,4,8")
    p.add_argument("-p", "--pairs_per_device", type=int, default=256)
    p.add_argument("-f", "--n_feats", type=int, default=1024)
    p.add_argument("-t", "--trials", type=int, default=5)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.device = resolve_device(args.device)
    profile_dir = args.profile or os.environ.get("OMT_PROFILE_DIR")
    try:
        if profile_dir and not torch.autograd._profiler_enabled():
            from openmvg_torch.utils.logging import start_profiler, stop_profiler

            start_profiler(profile_dir)
            try:
                return args.fn(args)
            finally:
                stop_profiler()
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename or e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
