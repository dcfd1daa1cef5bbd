"""The sparse plain reference of the benchmark's largest BAL cell
(benchmark/reference/bal_lm_sparse.py) against the dense one
(benchmark/reference/bal_lm.py), and the cell's driver
(benchmark/drivers/ba_solve_sparse.py) on a tiny configuration, on the
CPU in float64.
"""

import ast
import json
import os

import pytest
import torch

from benchmark.drivers import ba_solve, ba_solve_sparse
from benchmark.gen import bal
from benchmark.reference import bal_lm, bal_lm_sparse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(n_cams=12, n_points=240, n_obs=1300, seed=3):
    prob = bal.make_problem(None, n_cams, n_points, n_obs, problem_seed=seed)
    return ba_solve.reference_inputs(prob, "cpu", torch.float64)


def _held(n_cams, seed=1):
    """Principal points and k3 a camera, held, not 0."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n_cams, 2), generator=g, dtype=torch.float64),
            1e-3 * torch.randn((n_cams,), generator=g, dtype=torch.float64))


@pytest.mark.parametrize("case", ["plain", "held_pp_k3", "fixed_intrinsics", "small_blocks"])
def test_sparse_solve_equals_the_dense_solve(case):
    """Eight LM steps from the same start.  The dense reference solves each
    step exactly (Cholesky); the sparse one by block-Jacobi CG to a
    relative residual of 1e-12 on the reduced camera system, whose
    condition number here is far below 1e3, so each step agrees to about
    1e-12 relative and the LM takes the same branches: iterates and costs
    within 1e-9 relative of the dense solve's."""
    start, data = _inputs()
    kw = {}
    if case == "held_pp_k3":
        kw["pp"], kw["k3"] = _held(12)
    if case == "fixed_intrinsics":
        kw["fix_intr"] = True
    sparse_kw = dict(kw, obs_block=97, pair_block=500) if case == "small_blocks" else kw
    stats = []
    dense = bal_lm.solve(*start, *data, max_iterations=8, **kw)
    sparse = bal_lm_sparse.solve(*start, *data, max_iterations=8, stats=stats, **sparse_kw)
    assert dense[5] == sparse[5]
    assert stats and all(s["cg_rel_residual"] <= bal_lm_sparse.CG_TOL for s in stats)
    for a, b in zip(sparse[:4], dense[:4]):
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max())
    assert abs(sparse[4] - dense[4]) <= 1e-9 * dense[4]
    assert sparse[4] < bal_lm.robust_cost(*start, *data, **{k: v for k, v in kw.items()
                                                             if k != "fix_intr"})


def test_blockwise_cost_equals_the_dense_cost():
    start, data = _inputs()
    pp, k3 = _held(12)
    for block in (1 << 22, 100, 7):
        got = bal_lm_sparse.robust_cost(*start, *data, pp=pp, k3=k3, obs_block=block)
        assert got == pytest.approx(bal_lm.robust_cost(*start, *data, pp=pp, k3=k3),
                                    rel=1e-13)


def test_the_reference_imports_neither_jax_nor_the_program():
    for rel in ("benchmark/reference/bal_lm_sparse.py", "benchmark/drivers/ba_solve_sparse.py"):
        with open(os.path.join(ROOT, rel)) as f:
            tree = ast.parse(f.read())
        names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert not names & {"jax", "jaxlib", "openmvg_tpu"}
        if rel.startswith("benchmark/reference"):
            assert "openmvg_torch" not in names
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _tiny_state():
    with open(os.path.join(ROOT, "benchmark", "configs", "bal-final-13682.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "traffic", "refine-n10.json")) as f:
        traffic = json.load(f)
    cfg.update(n_cameras=30, n_points=700, n_observations=4500, dtype="float64")
    assert traffic["driver"] == "ba_solve_sparse"
    state = ba_solve_sparse.setup(cfg, dict(traffic, **ba_solve_sparse.NO_WARMUP),
                                  2 ** 33 + 5, "cpu", None, lambda m: None)
    return state, ba_solve_sparse.window(state, 0.0, _Rec())


class _Rec:
    unit = units = 0


def test_the_driver_s_check_passes_a_sound_solve_and_fails_a_fault():
    """The cell's check on a tiny configuration: the program's solve of 10
    LM steps reads well inside the cell's limit; the same solve with its
    points moved by 0.05 (five times the start's perturbation) reads past
    it."""
    with open(os.path.join(ROOT, "benchmark", "limits", "bal-final.refine-n10.json")) as f:
        limits = json.load(f)
    state, out = _tiny_state()
    assert out["attempted"] == 1
    sol = state.solutions[0]
    ok = ba_solve_sparse.check(state, out, limits, lambda m: None)["ba_excess"]
    assert ok["ok"] and 0 <= ok["value"] < limits["ba_excess"]
    g = torch.Generator().manual_seed(2)
    X = sol[3] + 0.05 * torch.randn(sol[3].shape, generator=g, dtype=sol[3].dtype)
    state.solutions = [(*sol[:3], X, sol[4])]
    bad = ba_solve_sparse.check(state, out, limits, lambda m: None)["ba_excess"]
    assert not bad["ok"] and bad["value"] > limits["ba_excess"]
