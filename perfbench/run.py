"""Run one cell of the benchmark once, on one NVIDIA card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It builds the cell named in BENCHMARK.json
(perfbench/harness.py), measures for `--seconds`, checks the outputs
against the plain reference (perfbench/check.py), and prints as its last
line of standard output one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics with --trace 0, its per-layer
metrics with --trace 1), device, with --trace 1 breakdown, and last the
numbers checked with their limits (also the last lines of standard error).
It exits with a code other than 0, printing no result, where no CUDA card
is visible, where BENCHMARK.json or the cell's files are missing, or where
jax, jaxlib, flax or pcf_tpu is loaded once the window has closed.
"""

import os
import time

T0 = time.perf_counter()
# one process with few threads: the window's host work is one Python loop,
# and idle worker threads of a thread pool only contend for the host's cores
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from perfbench import harness

    harness.cache_dirs()
    if not os.path.exists(os.path.join(ROOT, "BENCHMARK.json")):
        print("no BENCHMARK.json beside perfbench/", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark runs on the card only", file=sys.stderr)
        return 3

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                      t_start=T0, log=log)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of jax, jaxlib, flax or pcf_tpu loaded: {found}", file=sys.stderr)
        return 4
    for name, value, limit in out["checks"]:
        log(f"{name} {value!r} limit {limit!r}")
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
