"""The control fails where the program passes, on the card, through the
drivers' own check and the cells' limits: the plain reference's solve in
TF32 (BAL), and the program's scene held in TF32 or a planted fault
(fountain).  At a tenth of the BAL problem and a quarter of the
fountain's frame, so that a test run holds it; the readings the limits
were set from are the cells' own sizes (benchmark/control.py, PERF.md)."""

import pytest

from benchmark import control, harness


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_bal_control_fails_where_the_program_passes(seed, tmp_path, monkeypatch):
    _card()
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    r = harness.resolve(harness.load_spec(), "bal-dubrovnik.refine")
    r["config"].update(n_points=22673, n_observations=125527)
    row = control.readings(r, seed, "cuda", harness.log)
    assert row["program"]["correct"] and not row["tf32"]["correct"], row


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_fountain_control_fails_where_the_program_passes(seed, tmp_path, monkeypatch):
    _card()
    import tempfile

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    r = harness.resolve(harness.load_spec(candidates=True), "fountain-P11.incremental")
    r["config"].update(width=1536, height=1024, focal=1379.74)
    row = control.readings(r, seed, "cuda", harness.log)
    assert row["program"]["correct"], row
    assert not any(row[c]["correct"] for c in ("tf32", "poses_swapped", "matches_shifted")), row
