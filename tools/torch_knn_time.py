"""The kNN within scenes on the card at the 10 cm training shapes: each of the
13 edge sets of one preparation through the kernel (ops/kernels/knn_scene.py,
each call grouping its own rows) and through the plain version
(ops/knn.knn_plain on the card), then the whole preparation eagerly
(compute_knn_packed, groupings shared) and as make_prepare's CUDA graph.

    python3 tools/torch_knn_time.py [--seed N] [--reps R] [--plain-reps P]

The batch is the first of perfbench's pcf10_train_devknn pool for the seed
(16 rooms, the host pyramid without edges, the pinned caps). Prints the
card's name and power limit, the compiler's report for knn_scene.cu, then a
line per edge set: M, N, the valid pairs within scenes, the kernel's ms
(CUDA events over R calls), its bound (8 f32 operations a valid pair over 67
TFLOP/s, or the indices written over 3.35 TB/s, the larger), the plain
version's ms (over P calls) and the rows whose neighbour sets differ from
the plain version's where its k-th and (k+1)-th distances are apart; then the
preparation's lines and one JSON line. Raises if any set differs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PEAK_F32, PEAK_BYTES = 67e12, 3.35e12
OPS_PER_PAIR = 8
TIE_RTOL = 1e-6


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def devknn_batch(seed: int, device="cuda"):
    """(cfg, the pool's first batch on `device`, the caps) of
    pcf10_train_devknn."""
    from perfbench.harness import find_cell, pack_pool, program_items, rooms
    from pcf_torch.config import Config, get_default_configs, get_default_training_cfgs

    cell = find_cell("pcf10_train_devknn")
    cfg = Config.from_dict(cell.cfg)
    cfg = get_default_training_cfgs(get_default_configs(cfg, cfg.num_level, cfg.base_dim))
    scenes, room_seeds = rooms(cell, seed)
    items = program_items(cfg, scenes, room_seeds)
    batches, caps = pack_pool(cfg, items, list(np.argsort(room_seeds)), cell.batch_size)
    return cfg, batches[0].to(device), caps


def edge_sets(batch, cfg):
    from pcf_torch.data.post_knn import _ks

    k_self, k_fwd, k_prop = _ks(cfg)
    n = len(batch.points)
    out = []
    for lvl in range(n):
        out.append((f"self {lvl}", lvl, lvl, k_self[lvl]))
        if lvl < n - 1:
            out.append((f"forward {lvl + 1}->{lvl}", lvl + 1, lvl, k_fwd[lvl + 1]))
            out.append((f"propagate {lvl}->{lvl + 1}", lvl, lvl + 1, k_prop[lvl]))
    return out


def valid_pairs(qb, rb, rm, S: int) -> int:
    qc = torch.bincount(qb[(qb >= 0) & (qb < S)].long(), minlength=S)
    rc = torch.bincount(rb[rm & (rb >= 0) & (rb < S)].long(), minlength=S)
    return int((qc * rc).sum())


def differing_sets(gi, pi, pd_next, rows) -> int:
    """Rows (of `rows`) whose neighbour set differs from the plain version's
    where its k-th and (k+1)-th distances are apart."""
    distinct = (pd_next[:, -1] - pd_next[:, -2]) > TIE_RTOL * pd_next[:, -1]
    same = (torch.sort(gi, 1).values == torch.sort(pi, 1).values).all(1)
    return int((rows & distinct & ~same).sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--plain-reps", type=int, default=2)
    args = ap.parse_args(argv)

    from pcf_torch.data.post_knn import _ks, compute_knn_packed, make_prepare
    from pcf_torch.ops.kernels import build as kbuild
    from pcf_torch.ops.kernels import knn_scene as ks
    from pcf_torch.ops.knn import knn, knn_plain
    from pcf_torch.parallel.graphs import StepGraphs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__}", flush=True)
    report = kbuild.build(("knn_scene",))["knn_scene"]
    print("\n".join(f"[ptxas] {ln.strip()}" for ln in report.splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling" in ln), flush=True)
    cfg, b, caps = devknn_batch(args.seed)
    S = int(cfg.BATCH_SIZE)
    print(f"[batch] caps {caps}, valid rows {[int(m.sum()) for m in b.masks]}, scenes {S}",
          flush=True)

    rows, bad, tot = [], 0, dict(kernel=0.0, plain=0.0, bound=0.0, pairs=0)
    with torch.no_grad():
        for label, ql, rl, k in edge_sets(b, cfg):
            q, r = b.points[ql], b.points[rl]
            kw = dict(query_bid=b.bids[ql], ref_bid=b.bids[rl], ref_mask=b.masks[rl])
            ms = cuda_ms(lambda: knn(q, r, k, n_scenes=S, **kw), args.reps)
            plain_ms = cuda_ms(lambda: knn_plain(q, r, k, **kw), args.plain_reps)
            gi, gd = knn(q, r, k, n_scenes=S, return_dist=True, **kw)
            pi, pd = knn_plain(q, r, k + 1, return_dist=True, **kw)
            qm = (b.bids[ql] >= 0) & (b.bids[ql] < S)
            diff = differing_sets(gi, pi[:, :k], pd, qm)
            dist_err = float(((gd - pd[:, :k]).abs() / pd[:, :k].clamp(min=1e-30))[qm].max())
            pairs = valid_pairs(b.bids[ql], b.bids[rl], b.masks[rl], S)
            bound = max(OPS_PER_PAIR * pairs / PEAK_F32, q.shape[0] * k * 4 / PEAK_BYTES) * 1e3
            bad += diff
            for key, v in (("kernel", ms), ("plain", plain_ms), ("bound", bound),
                           ("pairs", pairs)):
                tot[key] += v
            rows.append(dict(set=label, M=q.shape[0], N=r.shape[0], k=k, pairs=pairs, ms=ms,
                             bound_ms=bound, plain_ms=plain_ms, differing=diff,
                             dist_rel_err=dist_err))
            print(f"[knn] {label}: M={q.shape[0]} N={r.shape[0]} k={k} valid pairs {pairs:.3e}; "
                  f"kernel {ms:.4f} ms, bound {bound:.4f} ms ({bound / ms:.1%}); plain "
                  f"{plain_ms:.2f} ms; sets differing {diff}, distances within "
                  f"{dist_err:.2e} relative", flush=True)

        eager_ms = cuda_ms(lambda: compute_knn_packed(b, *_ks(cfg), n_scenes=S), args.reps)
        launches = {}
        real_capture = StepGraphs._capture

        def capture(graphs, *a, **kw):
            n0 = ks.knn_scene.launches
            out = real_capture(graphs, *a, **kw)
            launches["capture"] = ks.knn_scene.launches - n0
            return out

        StepGraphs._capture = capture
        try:
            prep = make_prepare(cfg)
            prep(b, "cuda")
        finally:
            StepGraphs._capture = real_capture
        graph_ms = cuda_ms(lambda: prep(b, "cuda"), args.reps)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            prep(b, "cuda")
        host_ms = (time.perf_counter() - t0) / args.reps * 1e3
        torch.cuda.synchronize()
    print(f"[prepare] 13 edge sets: kernels alone {tot['kernel']:.3f} ms (bound "
          f"{tot['bound']:.4f} ms, {tot['pairs']:.3e} valid pairs), plain {tot['plain']:.1f} ms; "
          f"compute_knn_packed eager {eager_ms:.3f} ms; make_prepare's graph {graph_ms:.3f} ms "
          f"a call ({host_ms:.3f} ms of host); knn_scene launches in its capture "
          f"{launches.get('capture')}", flush=True)
    print(json.dumps(dict(card=smi, seed=args.seed, sets=rows, kernel_ms=tot["kernel"],
                          bound_ms=tot["bound"], plain_ms=tot["plain"], eager_ms=eager_ms,
                          graph_ms=graph_ms, graph_host_ms=host_ms,
                          capture_launches=launches.get("capture"), differing=bad)))
    if bad:
        raise SystemExit(f"{bad} rows' neighbour sets differ from the plain version's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
