"""Shared fixtures of the benchmark's own tests: a checkout-like root at
a tiny size, for CPU rehearsals of whole runs."""

import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

TINY = {
    "strecha-fountain-P11": dict(n_views=5, width=480, height=320, focal=431.0, arc_step=0.12),
    "bal-dubrovnik-356": dict(n_cameras=20, n_points=600, n_observations=3300,
                              dtype="float64"),
}


def make_root(path):
    """A copy of the benchmark's data files with every configuration cut to
    a size the CPU runs in seconds, and the cells of candidates.json
    admitted beside BENCHMARK.json's; returns the root."""
    b = os.path.join(path, "benchmark")
    for d in ("metrics", "traffic", "limits", "configs"):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(b, d))
    shutil.copy(os.path.join(BENCH, "candidates.json"), b)
    from benchmark import harness

    with open(os.path.join(path, "BENCHMARK.json"), "w") as fh:
        json.dump(harness.load_spec(ROOT, candidates=True), fh)
    for name, cut in TINY.items():
        f = os.path.join(b, "configs", name + ".json")
        with open(f) as fh:
            cfg = json.load(fh)
        cfg.update(cut)
        with open(f, "w") as fh:
            json.dump(cfg, fh)
    for t in ("incremental", "global"):
        f = os.path.join(b, "traffic", t + ".json")
        with open(f) as fh:
            tr = json.load(fh)
        tr["warmup_views"] = 0
        with open(f, "w") as fh:
            json.dump(tr, fh)
    return str(path)


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    return make_root(tmp_path / "root")
