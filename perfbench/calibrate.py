"""The readings the check's limits are set from (perfbench/limits/), on the
card at a cell's own size:

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,... \
        [--seconds 2] [--control-seeds 7,8,9] [--fault-seeds 4,5,6]

For each of --seeds: one whole run of the cell (perfbench/harness.py, a
short window), its numbers printed: the program's sound readings. For each
of --control-seeds: the control, the reference itself put in the
program's place at the next precision below the configuration's (TF32 for
float32, float8 e4m3 operands for bfloat16), against the float32
reference; for a training cell also the witness, the float32 reference
against itself in float64, which shows the rounding a number carries
whatever computes it. For each of --fault-seeds (training cells): a whole
run with the fault "half of the batch left out" planted in the program
(every other scene masked out, the mean over the rest). A step that
leaves its state unchanged reads 1 on update_gap by its definition and
needs no run. Each
reading is one line `[reading] <kind> seed=<n> <name>=<value> ...`.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _line(kind, seed, numbers):
    print(f"[reading] {kind} seed={seed} "
          + " ".join(f"{k}={v:.6g}" for k, v in numbers.items()), flush=True)


def controls(cell, seed, device):
    """The control's numbers on one seed, and for a training cell the
    witness: the float32 reference against itself in float64."""
    import torch

    from perfbench import check, harness, weights
    from perfbench.reference.model import Precision

    scenes, _ = harness.rooms(cell, seed)
    w0 = weights.draw(cell.cfg, seed, device)
    low = cell.meta["dtype"] == "float32"
    prec = Precision("f32" if low else "fp8")
    if cell.traffic["loop"] == "train":
        ref = check.reference_train(cell, scenes, w0, device)
        wit = check.reference_train(cell, scenes, w0, device, dtype=torch.float64)
        _line("witness_f32_vs_f64", seed, check.train_numbers(ref, wit, w0))
        del wit
        ctl = check.reference_train(cell, scenes, w0, device, prec=prec, tf32=low)
        _line("control", seed, check.train_numbers(ctl, ref, w0))
        return
    ref = check.reference_eval(cell, scenes, w0, device)
    ctl = check.reference_eval(cell, scenes, w0, device, prec=prec, tf32=low)
    worst = {}
    for b in ref:
        got = check.eval_gaps(ctl[b], ctl[b].argmax(-1), ref[b])
        worst = {k: max(worst.get(k, 0.0), v) for k, v in got.items()}
    _line("control", seed, worst)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                    help="a configuration key set for these runs (a witness: the "
                         "program at another setting)")
    args = ap.parse_args()
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    harness.cache_dirs()
    cell = harness.find_cell(args.workload)
    for kv in args.set:
        key, value = kv.split("=", 1)
        cell.meta = dict(cell.meta, config=dict(cell.meta["config"], **{key: json.loads(value)}))
    runs = [(int(x), None) for x in args.seeds.split(",") if x]
    if cell.traffic["loop"] == "train":
        runs += [(int(x), "half_batch") for x in args.fault_seeds.split(",") if x]
    for s, fault in runs:
        t = time.perf_counter()
        out = harness.run(cell, s, args.seconds, False, device="cuda", fault=fault,
                          log=lambda m: print(m, file=sys.stderr, flush=True))
        _line("fault_" + fault if fault else "program", s, out["readings"])
        print(f"[run] seed={s} fault={fault} correct={out['result']['correct']} setup_s="
              f"{out['setup_s']:.3f} metrics={out['result']['metrics']} took "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        torch.cuda.empty_cache()
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        controls(cell, s, torch.device("cuda"))
        print(f"[run] control seed={s} took {time.perf_counter() - t:.1f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
