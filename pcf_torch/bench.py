"""Benchmark: PCF_Normal-scale segmentation inference throughput on one card.

    python3 -m pcf_torch.bench

Prints ONE JSON line with the keys of the repository's bench.py: metric,
value (valid level-0 points/s), unit, ms_per_batch, ms_min, ms_max,
pts_per_sec_min, pts_per_sec_max, valid_points, and `device`, the card's
name and power limit as nvidia-smi reports them.

Workload, as bench.py's: the flagship PointConvFormer_Segmentation
(PCF_Normal capacity grid: 5 levels, 8 heads, resblocks [0,2,4,6,6], mid_dim
16) eval forward in bfloat16, in bench.py's configuration (the contraction
outside the fused kernels, the gathers through the window resolve), on
entry.flagship_batch(level0_points=20000, bucket=4096, n_scenes=2,
window_gather=True), the BN running statistics calibrated by one train-mode
pass. The timed function is the eval step of
entry.build_eval, captured once as a CUDA graph and replayed, with the packed
batch (geometry included) copied into the graph's inputs on every call, as a
new batch would be; timed with utils/timing.time_fn_stats(iters=10, reps=5).
`workload()` builds the model, step and batch and `run()` times them, so
that chip_smoke.py can hold this path's kernel calls and logits against
their plain versions and the eager forward before it times it.

bench.py's vs_baseline and baseline_derivation are left out: they divide by
a derived estimate of the reference's A100 throughput, made for the TPU
package, which is not a measurement on this card.
"""

from __future__ import annotations

import json
import subprocess

import torch


def device_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def workload(device=None):
    """(model, eval_step, batch): bench.py's model and batch, the BN running
    statistics calibrated, and entry.build_eval's captured eval step, not
    yet called."""
    from pcf_torch.entry import build_eval, flagship_batch

    cfg, batch = flagship_batch(level0_points=20000, bucket=4096, n_scenes=2,
                                window_gather=True, device=device)
    cfg.compute_dtype = "bfloat16"
    cfg.window_gather = True
    model, eval_step = build_eval(cfg, device=device)
    with torch.no_grad():  # BN calibration: one train-mode pass, as bench.py
        model.train()
        model.forward_batch(batch)
        model.eval()
    return model, eval_step, batch


def run(model, eval_step, batch) -> dict:
    """Time eval_step(model, batch) and print the JSON line; returns it."""
    from pcf_torch.utils.timing import time_fn_stats

    st = time_fn_stats(eval_step, model, batch, iters=10, reps=5)
    dt = st["median"]
    valid_points = int(batch.masks[0].sum())
    result = {
        "metric": "PCF_Normal 10cm eval throughput (synthetic scenes, 1 card)",
        "value": round(valid_points / dt, 1),
        "unit": "points/sec",
        "ms_per_batch": round(dt * 1e3, 3),
        "ms_min": round(st["min"] * 1e3, 3),
        "ms_max": round(st["max"] * 1e3, 3),
        "pts_per_sec_min": round(valid_points / st["max"], 1),
        "pts_per_sec_max": round(valid_points / st["min"], 1),
        "valid_points": valid_points,
        "device": device_line(),
    }
    print(json.dumps(result), flush=True)
    return result


def main() -> dict:
    return run(*workload())


if __name__ == "__main__":
    main()
