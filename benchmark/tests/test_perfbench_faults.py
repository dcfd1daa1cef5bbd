"""A whole run, past the harness's look for a card, with the timed path
broken underneath: `correct` has to come out false for each fault that a
cell can have.  On the CPU, at the tiny sizes of conftest.TINY."""

import pytest
import torch

from benchmark import harness


def _step_returns_state_unchanged(monkeypatch):
    from openmvg_torch.sfm import ba

    def lm_step(p, lam, cfg, cam_fast=None, group=None, shard_points=False):
        lam = torch.as_tensor(lam, dtype=p.X.dtype)
        return p, lam, ba.robust_cost(p, cfg, bool(cam_fast)), torch.tensor(True)

    monkeypatch.setattr(ba, "lm_step", lm_step)


def _answer_altered(monkeypatch):
    from openmvg_torch.sfm import ba

    orig = ba.adjust

    def adjust(p, *a, **kw):
        q, cost, n = orig(p, *a, **kw)
        return q._replace(X=q.X + 0.01), cost, n

    monkeypatch.setattr(ba, "adjust", adjust)


def _half_the_observations_left_out(monkeypatch):
    from openmvg_torch.sfm import ba

    orig = ba.adjust

    def adjust(p, *a, **kw):
        w = p.obs_w.clone()
        w[::2] = 0
        return orig(p._replace(obs_w=w), *a, **kw)

    monkeypatch.setattr(ba, "adjust", adjust)


@pytest.mark.parametrize("fault", [_step_returns_state_unchanged, _answer_altered,
                                   _half_the_observations_left_out])
def test_bal_cell_fails_under_each_fault(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    r = harness.run_cell("bal-dubrovnik.refine", 21, 0.0, 0, device="cpu", root=tiny_root)
    assert r["correct"] is False, r["checks"]


def test_bal_cell_passes_unbroken(tiny_root):
    r = harness.run_cell("bal-dubrovnik.refine", 21, 0.0, 0, device="cpu", root=tiny_root)
    assert r["correct"] is True, r["checks"]


def _engine_returns_scene_unchanged(monkeypatch):
    from openmvg_torch.sfm import pipeline_incremental

    monkeypatch.setattr(pipeline_incremental, "incremental_sfm",
                        lambda scene, feats, matches, cfg, device=None, stats=None:
                        stats.update(polish_steps=0, rounds=0))


def _scene_altered_where_written(monkeypatch):
    from openmvg_torch.io import sfm_data

    orig = sfm_data.save_sfm_data

    def save(scene, path, *a):
        scene.X = scene.X + 0.02
        return orig(scene, path, *a)

    monkeypatch.setattr(sfm_data, "save_sfm_data", save)


@pytest.mark.parametrize("fault", [None, _engine_returns_scene_unchanged,
                                   _scene_altered_where_written])
def test_fountain_cell_under_each_fault(tiny_root, monkeypatch, fault):
    if fault:
        fault(monkeypatch)
    r = harness.run_cell("fountain-P11.incremental", 22, 0.0, 0, device="cpu", root=tiny_root)
    assert r["correct"] is (fault is None), r["checks"]


def test_a_solve_with_its_cameras_relabelled_is_the_same_solve():
    import json
    import os

    import numpy as np

    from benchmark.drivers import ba_solve
    from benchmark.gen import bal
    from openmvg_torch.sfm import ba

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "configs", "bal-dubrovnik-356.json")) as f:
        cfg = dict(json.load(f), dtype="float64")
    p0 = ba_solve.program_problem(bal.make_problem(None, 20, 600, 3300, problem_seed=5), cfg,
                                  "cpu")
    a, ca, _ = ba.adjust(ba_solve.fresh(p0), ba.BAConfig(max_iterations=30))
    q = torch.as_tensor(np.random.default_rng(3).permutation(20))
    b, cb, _ = ba.adjust(ba_solve.fresh(p0, q), ba.BAConfig(max_iterations=30))
    assert cb == pytest.approx(ca, rel=1e-12)
    torch.testing.assert_close(b.rotvec[q], a.rotvec, rtol=0, atol=1e-12)
    torch.testing.assert_close(b.intr_params[q], a.intr_params, rtol=0, atol=1e-9)


def test_a_solve_whose_cost_is_not_a_number_is_not_correct(tiny_root, monkeypatch):
    from openmvg_torch.sfm import ba

    orig = ba.adjust

    def adjust(p, *a, **kw):
        q, cost, n = orig(p, *a, **kw)
        return q._replace(X=q.X * float("nan")), cost, n

    monkeypatch.setattr(ba, "adjust", adjust)
    r = harness.run_cell("bal-dubrovnik.refine", 23, 0.0, 0, device="cpu", root=tiny_root)
    assert r["correct"] is False and r["checks"]["ba_excess"]["value"] == float("inf")


@pytest.mark.parametrize("name", ["unposed", "ba_excess", "pose_rmse", "epi_bad_share"])
def test_a_fountain_reading_that_is_not_a_number_fails(tmp_path, monkeypatch, name):
    from types import SimpleNamespace

    from benchmark.drivers import pipeline

    got = dict(unposed=0, ba_excess=0.0, pose_rmse=0.0, epi_bad_share=0.0, reproj_rmse_px=0.1)
    got[name] = float("nan")
    monkeypatch.setattr(pipeline, "readings", lambda state, path: got)
    state = SimpleNamespace(done=[(str(tmp_path), None)])
    limits = {"unposed": 0, "ba_excess": 0.01, "pose_rmse": 0.02, "epi_bad_share": 0.1}
    checks = pipeline.check(state, {}, limits, lambda m: None)
    assert [k for k, c in checks.items() if not c["ok"]] == [name]


@pytest.mark.parametrize("control", ["tf32", "poses_swapped", "matches_shifted"])
def test_fountain_controls_through_the_check_are_not_correct(tiny_root, control):
    from benchmark import control as ctl

    spec = harness.load_spec(tiny_root)
    r = harness.resolve(spec, "fountain-P11.incremental", tiny_root)
    row = ctl.readings(r, 24, "cpu", lambda m: None, root=tiny_root)
    assert row["program"]["correct"] is True, row
    assert row[control]["correct"] is False, row
