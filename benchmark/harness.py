"""The benchmark of openmvg_torch, driven by BENCHMARK.json.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is found by its name:

  benchmark/configs/<config>.json   the deployment's sizes and settings
  benchmark/traffic/<traffic>.json  the mix; its "driver" names the module
                                    of benchmark/drivers/ that runs it
  benchmark/limits/<workload>.json  the limit of each number the cell's
                                    correctness check compares
  benchmark/metrics/<metric>.py     a per-layer metric's reader:
                                    read(ctx) -> number, or None when the
                                    run holds nothing to read

benchmark/candidates.json holds entries of the same form as
BENCHMARK.json's for cells that are built but not admitted (PERF.md says
why); load_spec(candidates=True) adds them, for rehearsals and controls.

A run: set-up (inputs from the seed, kernels loaded from the checkout's
build cache, warm-up), a measured window of --seconds, then, with the
window closed and the peak memory read, the check against the plain
reference.  With --trace 0 the result holds the cell's end-to-end
metrics; with --trace 1 its per-layer metrics, from the benchmark's
spans, counters and one profiler session over the window.
"""

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "openmvg_tpu")


class CellError(RuntimeError):
    pass


def load_spec(root=ROOT, candidates=False):
    spec = _json(root, "BENCHMARK.json")
    if candidates:
        for key, entries in _json(root, "benchmark", "candidates.json").items():
            spec[key] = spec[key] + entries
    return spec


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def resolve(spec, workload, root=ROOT):
    """The cell's entry, configuration, traffic and limits, by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    bench = os.path.join(root, "benchmark")
    return dict(cell=cell,
                config=_json(root, config["file"]),
                traffic=_json(bench, "traffic", cell["traffic"] + ".json"),
                limits=_json(bench, "limits", workload + ".json"))


def metrics_of(spec, workload, kind):
    """The end-to-end or per-layer metrics that this cell reports: those
    whose `workloads` list it, or, without the key, those that move an
    end-to-end metric the cell reports (end-to-end: every cell)."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if workload in m.get("workloads", ()) or
            ("workloads" not in m and m["moves"] in names)]


def reader(name, root=ROOT):
    """benchmark/metrics/<name>.py's read function (loaded by path: the
    names hold dots)."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(traffic):
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def workdir(workload):
    """The cell's fixed directory under TMPDIR, emptied for this run."""
    import shutil

    path = os.path.join(tempfile.gettempdir(), "omt_bench", workload)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def run_cell(workload, seed, seconds, trace, device="cuda", root=ROOT, spec=None):
    """One run of a cell; returns the result dict (checks last).  The
    device is the caller's: the command line passes the card only."""
    import torch

    from benchmark import hooks
    from benchmark.trace import DeviceTrace, Recorder

    spec = spec or load_spec(root)
    r = resolve(spec, workload, root)
    drv = driver(r["traffic"])
    on_card = torch.device(device).type == "cuda"
    rec = Recorder(bool(trace))

    t0 = time.perf_counter()
    state = drv.setup(r["config"], r["traffic"], seed, device, workdir(workload), log)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s (of it building kernels {state.build_s:.3f} s)")

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    dtrace = DeviceTrace(torch) if trace and on_card else None
    with hooks.installed(rec) if trace else contextlib.nullcontext():
        if dtrace:
            dtrace.start()
        out = drv.window(state, seconds, rec)
        if dtrace:
            dtrace.stop()
    log(f"window: {out['attempted']} attempted, {out['failed']} failed, {out['window_s']:.3f} s; "
        f"each: {getattr(state, 'unit_s', [])}")
    for i, st in enumerate(getattr(state, "stage_s", [])):
        log(f"stage seconds of unit {i}: {st}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    bad = forbidden_modules()
    if bad:
        raise CellError(f"modules of JAX or the JAX package are loaded: {bad}")

    result = {"attempted": out["attempted"], "failed": out["failed"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        ctx = dict(rec=rec, trace=dtrace, out=out, state=state, torch=torch)
        metrics = {}
        for m in metrics_of(spec, workload, "per_layer"):
            v = reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if dtrace:
            device_info["busy_s"] = dtrace.busy_s()
            device_info["window_s"] = dtrace.window_s
            result["breakdown"] = dtrace.breakdown(rec)
    else:
        metrics = {}
        values = dict(out["metrics"], setup_s=setup_s)
        for m in metrics_of(spec, workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    del dtrace
    rec.calls.clear()

    build_s = state.build_s
    checks = drv.check(state, out, r["limits"], log)
    del state, out
    gc.collect()
    correct = all(c["ok"] for c in checks.values()) and result["failed"] == 0
    result.update(correct=correct, metrics=metrics, device=device_info, build_s=build_s)
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result
