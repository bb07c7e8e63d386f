"""The check that decides `correct`: what the timed path produced, against
the plain reference (perfbench/reference/) on the same rooms and weights.

Training (the first `warm_steps` steps on batches 0, 1, 2 of the pool,
made by the window's own call as CUDA graph replays, as every step of the
window is: set-up ran the step's eager first call and capture once and
put the state back; the reference follows them from the same weights with
its own pyramid, edges, BatchNorm statistics, loss, clipping and AdamW):
  loss1_gap   |loss - reference's| / |reference's| of the first step;
  loss2_gap   the same of the second step, which sees the first update
              (forward, backward, clip and AdamW);
  loss_gap    the largest of every warm step (later steps swing: AdamW's
              first updates move each element by the sign of its gradient,
              and elements near nought flip under rounding);
  bn_stat_gap the worst BatchNorm running statistic (mean or variance of
              one layer) after the first step: |s - s_ref| / |s_ref|;
  train_logit_rms  the root mean square of the first step's logits minus
              the reference's, over the reference logits' own;
  grad_gap_median  the median leaf's gap of the first step's gradient
              before the clip: | |g| - |g_ref| | over the larger of |g_ref|
              and the median leaf's |g_ref|;
  grad_gap_q90, grad_gap_raw  the same at the 90th percentile and the
              worst leaf; grad_gap the worst leaf's of the gradient as AdamW
              got it (its first moment over 1 - beta1), after the clip;
  grad_norm_gap  the gap of the whole gradient's norm before the clip;
  update_gap  the gap between the median leaf's change of the parameters
              over the warm steps and the reference's, over the latter;
  update_gap_worst  the worst leaf's change gap, measured as the gradient's;
the gradient and change numbers over the leaves whose reference gradient
is at least ZERO_GRAD of the median leaf's (a bias before a BatchNorm has
a gradient of nought but for rounding, which AdamW turns into a full step);
and under a post_knn mix, of the edges the device preparation produced
for those steps (counts, exact: 0):
  edge_miss   edges of a real query that lie beyond its K nearest rows of
              its scene by more than EDGE_TOL, or repeat a neighbour;
  edge_cross  edges into another scene or a padded row;
  pyramid_miss host pyramid rows with no reference row within PYRAMID_TOL
              (each scene's rows matched by sorting).
Evaluation (every batch of the pool, as the window last produced it):
  logit_err   the largest |logit - reference's| over the batch's largest
              reference logit;
  logit_rms   the root mean square of logit - reference's over the
              reference logits' own;
  pred_gap    the largest margin by which the reference's logit of a
              returned prediction lies below its best, over the same scale;
  repeat_mismatch  predictions of one batch that differ between its calls
              (exact: 0).
A cell is held to the numbers its perfbench/limits/<workload>.json names,
each to its limit there; the others are read and printed, not compared.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import pyramid as rp
from perfbench.reference import train as rt
from perfbench.reference.model import F32, Precision, Segmentation

# leaves whose reference gradient is under this share of the median leaf's
# (a bias before a BatchNorm: nought but for rounding) are not compared
ZERO_GRAD = 1e-3
# a host-pyramid row matches the reference's within this many metres (the
# barycenters are float64 sums rounded to float32, summed in another order)
PYRAMID_TOL = 1e-6
# an edge lies beyond the K nearest when its squared distance exceeds the
# reference's K-th by more than this share (float32 rounding of distances
# computed in another order is some 1e-7)
EDGE_TOL = 1e-5


def _ks(cfg):
    return ([int(k) for k in cfg["K_self"]], [int(k) for k in cfg["K_forward"]],
            [int(k) for k in cfg["K_propagate"]])


def _batch_scenes(cell, scenes, b):
    B = cell.batch_size
    return scenes[b * B:(b + 1) * B]


def _reference(cell, w0, device):
    from perfbench.weights import load_reference

    model = Segmentation(cell.cfg).to(device)
    load_reference(w0, model)
    return model


class _TF32:
    """TF32 for float32 matrix products inside, off outside (the
    reference's own precision)."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.old


def _cast(s: dict, dtype) -> dict:
    """A scene set with its floating tensors in `dtype` (the edges, ids and
    labels as they are)."""
    def one(x):
        if isinstance(x, list):
            return [one(v) for v in x]
        return x.to(dtype) if isinstance(x, torch.Tensor) and x.is_floating_point() else x

    return {k: one(v) for k, v in s.items()}


def reference_train(cell, scenes, w0, device, prec: Precision = F32, tf32: bool = False,
                    dtype=torch.float32) -> dict:
    """The reference's warm steps: {"losses", "g1" (the first step's
    gradient as AdamW got it), "raw1" (the same before the clip), "logits1"
    (the first step's logits), "stats1" (the BatchNorm statistics after it),
    "after" (the parameters after the warm steps)} by reference parameter
    and buffer name. `dtype` float64 makes the witness that
    perfbench/calibrate.py holds the float32 reference to."""
    cfg = cell.cfg
    model = _reference(cell, w0, device).to(dtype)
    opt = rt.AdamW(model.parameters(), float(cfg["adamw_decay"]))
    weights = rt.class_weights([s[3] for s in scenes], cfg["num_classes"]).to(device, dtype)
    ipe = int(cell.meta["assumed"]["iter_per_epoch"])
    names = [n for n, _ in model.named_parameters()]
    out = {"losses": []}
    with _TF32(tf32):
        for t in range(int(cell.traffic["warm_steps"])):
            b = t % cell.traffic["pool_batches"]
            s = _cast(rp.scene_set(_batch_scenes(cell, scenes, b), cfg["grid_size"], _ks(cfg),
                                   device), dtype)
            loss, grads, raw, logits = rt.train_step(model, s, weights, cfg, opt,
                                                     rt.learning_rate(cfg, t, ipe), prec)
            out["losses"].append(float(loss))
            if t == 0:
                out["g1"] = {n: g.detach().clone() for n, g in zip(names, grads)}
                out["raw1"] = {n: g.detach().clone() for n, g in zip(names, raw)}
                out["logits1"] = logits.float()
                out["stats1"] = {n: b.detach().clone() for n, b in model.named_buffers()}
            del s, grads, raw, logits
    out["after"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    return out


def _leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    """{leaf: | |prog| - |ref| | over the larger of |ref| and the median
    leaf's |ref|}: the gap of the norms, leaf by leaf."""
    n_ref = {n: float(ref[n].norm()) for n in leaves}
    n_prog = {n: float(prog[n].norm()) for n in leaves}
    med = float(np.median(list(n_ref.values())))
    return {n: abs(n_prog[n] - n_ref[n]) / max(n_ref[n], med) for n in leaves}


def train_numbers(prog: dict, ref: dict, w0: dict, log=None) -> dict:
    """The training numbers of `prog` against `ref` (both by reference
    parameter name, their step-1 logits in one row order): see the module.
    The gradient and change numbers cover the leaves whose reference
    gradient is at least ZERO_GRAD of the median leaf's."""
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    gn_ref = {n: float(g.norm()) for n, g in ref["g1"].items()}
    med_g = float(np.median(list(gn_ref.values())))
    moved = [n for n in gn_ref if gn_ref[n] >= ZERO_GRAD * med_g]
    grad = _leaf_gaps(prog["g1"], ref["g1"], moved)
    raw = np.array(sorted(_leaf_gaps(prog["raw1"], ref["raw1"], moved).values()))
    norm_p = float(torch.stack([prog["raw1"][n].double().norm() for n in moved]).norm())
    norm_r = float(torch.stack([ref["raw1"][n].double().norm() for n in moved]).norm())
    d_ref = {n: (ref["after"][n] - w0[n]) for n in moved}
    d_prog = {n: (prog["after"][n] - w0[n]) for n in moved}
    change = _leaf_gaps(d_prog, d_ref, moved)
    med_ref = float(np.median([float(d.norm()) for d in d_ref.values()]))
    med_prog = float(np.median([float(d.norm()) for d in d_prog.values()]))
    stats = {n: float((prog["stats1"][n].double() - r.double()).norm() / r.double().norm())
             for n, r in ref["stats1"].items()}
    got, want = prog["logits1"].float(), ref["logits1"].float()
    out = {"loss1_gap": gaps[0], "loss2_gap": gaps[1] if len(gaps) > 1 else 0.0,
           "loss_gap": max(gaps), "bn_stat_gap": max(stats.values()),
           "train_logit_rms": float((got - want).pow(2).mean().sqrt()
                                    / want.pow(2).mean().sqrt()),
           "grad_gap": max(grad.values()), "grad_gap_raw": float(raw[-1]),
           "grad_gap_median": float(np.quantile(raw, 0.5)),
           "grad_gap_q90": float(np.quantile(raw, 0.9)),
           "grad_norm_gap": abs(norm_p - norm_r) / norm_r,
           "update_gap": abs(med_prog - med_ref) / med_ref,
           "update_gap_worst": max(change.values())}
    if log is not None:
        log("[check] loss per step " + "; ".join(
            f"{a:.9g} vs {b:.9g} ({g:.3g})"
            for a, b, g in zip(prog["losses"], ref["losses"], gaps)))
        for title, by in (("first gradient", grad), ("change", change)):
            worst = sorted(moved, key=lambda n: -by[n])[:3]
            log(f"[check] {len(moved)} of {len(gn_ref)} leaves; worst {title} gaps: "
                + "; ".join(f"{n} {by[n]:.4g}" for n in worst))
        worst = max(stats, key=stats.get)
        log(f"[check] BatchNorm statistics after step 1: worst {worst} {stats[worst]:.4g}")
    return out


def program_train(out: dict, w0: dict, model_keys) -> dict:
    """The program's warm-step outputs by reference parameter name (norms
    do not see the fused layers' transposed storage)."""
    from perfbench.weights import program_name

    keys = set(model_keys)
    res = {"losses": out["losses"], "stats1": out["stats1"], "logits1": out["logits1"]}
    for k in ("g1", "raw1", "after"):
        res[k] = {}
        for n in w0:
            p, t = program_name(n, keys)
            res[k][n] = out[k][p].t() if t else out[k][p]
    return res


# ------------------------------------------------------------ evaluation


def reference_eval(cell, scenes, w0, device, prec: Precision = F32,
                   tf32: bool = False) -> dict:
    """{batch: logits in the reference's row order} after the reference's
    own BatchNorm calibration (the same training-mode forwards over the
    pool, in order)."""
    cfg = cell.cfg
    P = cell.traffic["pool_batches"]
    model = _reference(cell, w0, device)
    out = {}
    with _TF32(tf32), torch.no_grad():
        model.train()
        for k in range(int(cell.traffic["calibration_passes"])):
            model(rp.scene_set(_batch_scenes(cell, scenes, k % P), cfg["grid_size"],
                               _ks(cfg), device), prec)
        model.eval()
        for b in range(P):
            s = rp.scene_set(_batch_scenes(cell, scenes, b), cfg["grid_size"], _ks(cfg),
                             device)
            out[b] = model(s, prec)
    return out


def level0_order(batch, scenes) -> tuple:
    """(program rows, reference rows): each scene's valid level-0 rows of
    the packed batch matched to the scene's own rows by their coordinates
    (the program may reorder them, as windowed gathers do)."""
    pts = batch.points[0].numpy()
    bids = batch.bids[0].numpy()
    prog_rows, ref_rows, off = [], [], 0
    for i, sc in enumerate(scenes):
        rows = np.nonzero(bids == i)[0]
        p = pts[rows]
        r = sc[0]
        if p.shape[0] != r.shape[0]:
            raise ValueError(f"scene {i}: {p.shape[0]} rows in the batch, {r.shape[0]} given")
        po = np.lexsort(p.T[::-1])
        ro = np.lexsort(r.T[::-1])
        if not np.array_equal(p[po], r[ro]):
            raise ValueError(f"scene {i}: the batch's level-0 points are not the scene's")
        prog_rows.append(rows[po])
        ref_rows.append(ro + off)
        off += r.shape[0]
    return np.concatenate(prog_rows), np.concatenate(ref_rows)


def eval_gaps(got, pred, ref) -> dict:
    """logit_err, logit_rms and pred_gap of logits `got` and predictions
    `pred` against the reference's logits `ref`, rows aligned."""
    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max())
    margin = ref.max(-1).values - ref.gather(1, pred.long()[:, None])[:, 0]
    return {"logit_err": float((got - ref).abs().max()) / scale,
            "logit_rms": float((got - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()),
            "pred_gap": float(margin.max()) / scale}


def eval_numbers(batches, scenes_of, logits_of, preds_of, ref_logits) -> dict:
    """logit_err and pred_gap over the pool's batches, the program's rows
    matched to the reference's."""
    out = {}
    for b, ref in ref_logits.items():
        pr, rr = level0_order(batches[b], scenes_of(b))
        pr_t = torch.from_numpy(pr).to(ref.device)
        rr_t = torch.from_numpy(rr).to(ref.device)
        got = eval_gaps(logits_of(b)[pr_t], preds_of(b)[pr].to(ref.device), ref[rr_t])
        out = {k: max(out.get(k, 0.0), v) for k, v in got.items()}
    return out


# -------------------------------------------------------- device pyramid


def edge_numbers(cell, batch, edges: dict, scenes, device) -> dict:
    """pyramid_miss, edge_miss, edge_cross of one prepared batch (counts)."""
    cfg = cell.cfg
    k_self, k_fwd, k_prop = _ks(cfg)
    L = len(cfg["grid_size"])
    counts = {"pyramid_miss": 0, "edge_miss": 0, "edge_cross": 0}
    ref_levels = [rp.level_points(c, n, cfg["grid_size"], k_self) for c, _, n, _ in scenes]
    for lvl in range(L):
        for i in range(len(scenes)):
            mine = batch.points[lvl].numpy()[batch.bids[lvl].numpy() == i]
            ref = ref_levels[i][0][lvl]
            if mine.shape != ref.shape:
                counts["pyramid_miss"] += abs(mine.shape[0] - ref.shape[0]) or 1
                continue
            a, r = mine[np.lexsort(mine.T[::-1])], ref[np.lexsort(ref.T[::-1])]
            counts["pyramid_miss"] += int((np.abs(a - r).max(1) > PYRAMID_TOL).sum())
    pts = [p.to(device) for p in batch.points]
    bids = [b.to(device) for b in batch.bids]

    def one(nei, q_lvl, r_lvl, k):
        nei = nei.to(device).long()
        for i in range(len(scenes)):
            q_rows = torch.nonzero(bids[q_lvl] == i)[:, 0]
            r_rows = torch.nonzero(bids[r_lvl] == i)[:, 0]
            got = nei[q_rows, :k]
            counts["edge_cross"] += int((bids[r_lvl][got] != i).sum())
            srt = got.sort(1).values
            counts["edge_miss"] += int((srt[:, 1:] == srt[:, :-1]).sum())
            q = pts[q_lvl][q_rows]
            d_got = rp.knn_distances(pts[r_lvl], q, got)
            ref_nei = rp.knn(pts[r_lvl][r_rows], q, k)
            kth = rp.knn_distances(pts[r_lvl][r_rows], q, ref_nei)[:, -1:]
            counts["edge_miss"] += int((d_got > kth * (1 + EDGE_TOL) + 1e-12).sum())

    for lvl in range(L):
        one(edges["edges_self"][lvl], lvl, lvl, k_self[lvl])
        if lvl < L - 1:
            one(edges["edges_forward"][lvl], lvl + 1, lvl, k_fwd[lvl + 1])
            one(edges["edges_propagate"][lvl], lvl, lvl + 1, k_prop[lvl])
    return {k: float(v) for k, v in counts.items()}


# ------------------------------------------------------------------ judge


def judge(cell, scenes, batches, w0, rec, program_out, device, log) -> tuple:
    """([(name, value, limit)] of the numbers the cell's limits name, every
    number read {name: value}); each is also printed."""
    numbers = {}
    if cell.traffic["loop"] == "train":
        ref = reference_train(cell, scenes, w0, device)
        prog = program_train(program_out, w0, program_out["names"])
        pr, rr = level0_order(batches[0], _batch_scenes(cell, scenes, 0))
        prog["logits1"] = prog["logits1"][torch.from_numpy(pr).to(prog["logits1"].device)]
        ref["logits1"] = ref["logits1"][torch.from_numpy(rr).to(ref["logits1"].device)]
        numbers.update(train_numbers(prog, ref, w0, log))
        del ref, prog
        for t, edges in enumerate(program_out.get("prep_edges") or []):
            b = t % len(batches)
            got = edge_numbers(cell, batches[b], edges, _batch_scenes(cell, scenes, b), device)
            for k, v in got.items():
                numbers[k] = max(numbers.get(k, 0.0), v)
    else:
        ref = reference_eval(cell, scenes, w0, device)
        numbers.update(eval_numbers(batches, lambda b: _batch_scenes(cell, scenes, b),
                                    lambda b: rec.logits[b], lambda b: rec.preds[b],
                                    {b: ref[b] for b in rec.logits}))
        numbers["repeat_mismatch"] = float(rec.repeat_mismatch)
        if len(rec.logits) < cell.traffic["pool_batches"]:
            numbers["batches_unanswered"] = float(cell.traffic["pool_batches"]
                                                  - len(rec.logits))
    out = []
    for name, value in numbers.items():
        if name in cell.limits or name == "batches_unanswered":
            out.append((name, float(value), float(cell.limits.get(name, 0.0))))
        else:
            log(f"[check] {name} {value:.6g} (read, not compared)")
    for name, value, limit in out:
        log(f"[check] {name} {value:.6g} limit {limit:.6g}"
            f"{'' if value <= limit else '  FAILED'}")
    return out, {k: float(v) for k, v in numbers.items()}
