"""The harness: cells, metrics and files found by name; no card, no
result; no module of JAX or the JAX package loaded."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def test_benchmark_json_names_files_that_exist():
    spec = harness.load_spec()
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in spec["workloads"]:
        r = harness.resolve(spec, w["name"])
        assert harness.driver(r["traffic"]).window
        assert r["limits"]
        assert harness.metrics_of(spec, w["name"], "per_layer")
    for m in spec["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_each_cell_reports_setup_one_other_end_to_end_metric_and_a_layer_metric():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(spec, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert all(m["moves"] in e2e for m in harness.metrics_of(spec, w["name"], "per_layer"))


def test_a_new_metric_file_and_entry_are_found_with_no_code_edit(tiny_root):
    with open(os.path.join(tiny_root, "benchmark", "metrics", "solves_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx['rec'].units)\n")
    with open(os.path.join(tiny_root, "benchmark", "traffic", "refine-short.json"), "w") as f:
        json.dump({"driver": "ba_solve", "max_iterations": 3, "warmup_steps": 0}, f)
    with open(os.path.join(tiny_root, "benchmark", "limits", "bal-dubrovnik.short.json"),
              "w") as f:
        json.dump({"ba_excess": 1.0}, f)
    spec_path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "bal-dubrovnik.short", "config": "bal-dubrovnik-356",
                              "traffic": "refine-short", "chips": 1, "why": "a test"})
    next(m for m in spec["end_to_end"] if m["name"] == "ba_solve_s")["workloads"].append(
        "bal-dubrovnik.short")
    spec["per_layer"].append({"name": "solves_seen", "unit": "solves", "better": "higher",
                              "source": "program_counter", "layer": "bundle adjuster",
                              "moves": "ba_solve_s", "workloads": ["bal-dubrovnik.short"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    r = harness.run_cell("bal-dubrovnik.short", 5, 0.0, 1, device="cpu", root=tiny_root)
    assert r["metrics"]["solves_seen"] == {"value": 1.0, "unit": "solves"}
    assert r["attempted"] == 1
    assert list(r)[-1] == "checks"


def test_a_reader_that_finds_nothing_leaves_its_metric_out(tiny_root):
    r = harness.run_cell("bal-dubrovnik.refine", 6, 0.0, 1, device="cpu", root=tiny_root)
    # off the card there is no device trace: no roofline, no idle share
    assert set(r["metrics"]) == {"lm_steps.ba"}
    assert r["correct"] is True


def test_candidate_cells_are_found_only_when_asked_for():
    admitted = {w["name"] for w in harness.load_spec()["workloads"]}
    both = harness.load_spec(candidates=True)
    assert "fountain-P11.incremental" not in admitted
    for w in both["workloads"]:
        r = harness.resolve(both, w["name"])
        assert harness.driver(r["traffic"]).window and r["limits"]
    assert {m["name"] for m in both["per_layer"]} >= {"sfm_s", "lm_steps.ba"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    monkeypatch.setitem(sys.modules, "openmvg_tpu_like", sys)
    assert not {"jaxish", "openmvg_tpu_like"} & set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert "flax" in harness.forbidden_modules()


def _run(args, env_extra, cwd=ROOT):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.update(env_extra)
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_means_no_result_and_a_nonzero_exit(tmp_path):
    p = _run(["--workload", "bal-dubrovnik.refine", "--seed", "1", "--seconds", "1",
              "--trace", "0"], {"TMPDIR": str(tmp_path)})
    assert p.returncode != 0
    assert p.stdout == ""
    assert "CUDA card" in p.stderr


def test_a_checkout_of_only_the_benchmark_fails_without_a_result(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "bal-dubrovnik.refine",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       env=dict(os.environ, TMPDIR=str(tmp_path)), capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_a_cpu_rehearsal_loads_no_jax_and_no_jax_package(tiny_root):
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from benchmark import harness\n"
            "r = harness.run_cell('bal-dubrovnik.refine', 3, 0.0, 1, device='cpu', root=%r)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
            % (ROOT, tiny_root))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, TMPDIR=os.environ["TMPDIR"]))
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "openmvg_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "openmvg_tpu"}


@pytest.mark.cuda
def test_one_short_run_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = _run(["--workload", "bal-dubrovnik.refine", "--seed", "2", "--seconds", "1",
              "--trace", "0"], {"TMPDIR": str(tmp_path), "CUDA_VISIBLE_DEVICES": "0"})
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["device"]["platform"] == "gpu" and r["correct"] is True
