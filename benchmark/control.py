"""Readings that the correctness limits are set from: the program's
numbers and the control's, seed by seed, at a cell's own size.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--no-control] [--candidate]

For each seed: the cell's set-up without its warm-up (the driver's
NO_WARMUP), one reconstruction or solve as the window runs it, and the
driver's own check against the cell's limits; then each of the driver's
CONTROLS put in the program's place (driver.control) and read by the
same check, which has to come out not correct.  The control is the
reference in the nearest precision below the configuration's (float32
with TF32 off, so TF32):
  ba_solve   the plain reference's own float64 solve from the start, held
             in TF32
  pipeline   the program's scene held in TF32 (the engines have no plain
             reference), and beside it the planted faults: two views'
             poses exchanged, each filtered match's second feature taken
             from the previous match
One JSON line a seed on standard output.  Needs a card.  --candidate
also finds the cell in benchmark/candidates.json.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)


def readings(r, seed, device, log, control=True, root=ROOT):
    """{"program": checks, "correct": bool, and per control name the
    same}: each check a {value, limit, ok}."""
    from benchmark import harness
    from benchmark.trace import Recorder

    drv = harness.driver(r["traffic"])
    name = r["cell"]["name"]
    traffic = dict(r["traffic"], **drv.NO_WARMUP)
    state = drv.setup(r["config"], traffic, seed, device, harness.workdir(name), log)
    out = drv.window(state, 0, Recorder(False))
    row = {"window_s": out["window_s"]}

    def judged(checks, o):
        ok = all(c["ok"] for c in checks.values()) and o["failed"] == 0
        return dict(correct=ok, **{k: {"value": c["value"], "limit": c["limit"]}
                                   for k, c in checks.items()})

    row["program"] = judged(drv.check(state, out, r["limits"], log), out)
    for c in (drv.CONTROLS if control else ()):
        o = drv.control(state, out, c, log)
        row[c] = judged(drv.check(state, o, r["limits"], log), o)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--no-control", action="store_true", help="the program's readings only")
    ap.add_argument("--candidate", action="store_true",
                    help="also look the cell up in benchmark/candidates.json")
    args = ap.parse_args()
    out_fd = os.dup(1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    from benchmark import harness

    r = harness.resolve(harness.load_spec(candidates=args.candidate), args.workload)
    for s in args.seeds.split(","):
        row = dict(workload=args.workload, seed=int(s),
                   **readings(r, int(s), "cuda", harness.log, not args.no_control))
        os.write(out_fd, (json.dumps(row, default=float) + "\n").encode())


if __name__ == "__main__":
    main()
