"""Benchmark of openmvg_torch on NVIDIA cards.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json in this process, on the card, and prints
one JSON line as the last line of standard output: correct, attempted,
failed, metrics, device (and with --trace 1 the breakdown), then the
numbers the correctness check compared, each beside its limit, which are
also the last lines of standard error.  Everything the program prints
goes to standard error.  Exits non-zero, printing no result, without a
CUDA card (or with fewer than the cell asks for), when a module of JAX
or of the JAX package is loaded, or when the run fails.
"""

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout
_CACHE = os.path.join(ROOT, ".bench_cache")
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--candidate", action="store_true",
                    help="also look the cell up in benchmark/candidates.json")
    args = ap.parse_args(argv)

    # the result goes to the real standard output; all else to standard error
    result_fd = os.dup(1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr

    from benchmark import harness

    spec = harness.load_spec(candidates=args.candidate)
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        harness.log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        harness.log(f"the cell needs {cell['chips']} CUDA card(s); "
                    f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
                    f"device_count() = {torch.cuda.device_count()}")
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, args.trace, spec=spec)
    for c in result["checks"].values():  # JSON has no infinity: a reading that is none
        if not math.isfinite(c["value"]):
            c["value"] = None
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"modules of JAX or the JAX package are loaded: {bad}")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    os.write(result_fd, (json.dumps(result, default=float, allow_nan=False) + "\n").encode())
    return 0


if __name__ == "__main__":
    sys.exit(main())
