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
    with open(args.output_file, "w") as f:
        for i, j in pairs:
            f.write(f"{i} {j}\n")
    print(f"{len(pairs)} pairs")
    return 0


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

    if args.ring_matching == "on":
        raise NotImplementedError(
            "ring matching streams descriptors across devices; it comes with "
            "the multi-GPU slice of the port (ROADMAP queue 1, item 9)")
    scene = _load_scene(args.input_file)
    matchdir = args.matchdir or os.path.dirname(args.output_file)
    feats, descs = _load_features_for_scene(scene, matchdir)
    pairs = (load_pairs_file(args.pair_list) if args.pair_list
             else exhaustive_pairs(scene.n_views))
    kw = dict(method=matcher_of(args.nearest_matching_method))
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
        pre = matching.match_descriptor_lists(sub, pairs, args.ratio, args.device, **kw)
        thr = 0.08 * k
        pairs = [pq for pq, m in pre.items() if len(m) >= thr]
        print(f"preemptive: kept {len(pairs)} pairs "
              f"(>= {thr:.0f} of {k} feats matched)")
    out = matching.match_descriptor_lists(descs, pairs, args.ratio, args.device, **kw)
    save_matches(out, args.output_file)
    n_m = sum(len(m) for m in out.values())
    print(f"{len(out)} matched pairs, {n_m} putative matches "
          f"in {time.time() - t0:.1f}s")
    return 0


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
    with open(args.output_file, "w") as f:
        for i, j in pairs:
            f.write(f"{i} {j}\n")
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


def build_parser():
    ap = argparse.ArgumentParser(prog="openmvg_torch",
                                 description=__doc__.splitlines()[0])
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
                   help="multi-device only; on one device auto = off")

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
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
