"""One run of one cell: set-up, the measured window, the check.

Everything a cell is made of is found by name: BENCHMARK.json's workload
entry names a configuration (perfbench/configs/<config>.json: the
configuration as it is run, under "config") and a traffic mix
(perfbench/traffic/<traffic>.json: the parameters this module's general
generator reads), and its per-layer metrics name their readers
(perfbench/metrics/<metric>.py, or the file of the name before the
metric's first dot). The limits of the check are
perfbench/limits/<workload>.json.

A run, in order:
  1. rooms from the traffic's fixed room seeds, ordered by the run's seed;
     each room's pyramid built by the program's host pipeline and packed
     into a pool of batches under pinned level caps; weights drawn from the
     seed on the card (perfbench/weights.py);
  2. the program's train step (and, under a post_knn mix, its device
     preparation) or eval step built, and warmed: a training run makes the
     step's first call (eager, then captured) once and puts the state back,
     then drives its first `warm_steps` steps, graph replays, through the
     window's own call on batches 0, 1, 2 of the pool, which the check
     follows; an eval run calibrates its BatchNorm statistics and calls the
     step until its graph replays;
  3. the window: the loop of the traffic for `seconds`; a train step at a
     time, and an eval mix's batches up to its `ahead_batches` in flight
     (their predictions read back as each one's copy ends), after which
     nothing more is sent and all that was sent is waited for and counted;
  4. the check against the plain reference (perfbench/check.py), after the
     program's state is freed.

The program is pcf_torch; nothing here imports jax or pcf_tpu.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import statistics
import sys
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "pcf_tpu")
# the host's spans around each call the window makes, in a traced run
ANNOTATIONS = ("copy_in", "prepare", "train_step", "eval_step", "predictions_to_host")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    """A workload of BENCHMARK.json with everything it names, found by
    name: its configuration file, its traffic file, its limits, and the
    metrics it reports."""

    name: str
    meta: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def cfg(self) -> dict:
        """The configuration as run: the file's `config`, with what the
        traffic sets (post_knn)."""
        cfg = dict(self.meta["config"])
        if self.traffic["pyramid"] == "post_knn":
            cfg["post_knn"] = True
        return cfg

    @property
    def batch_size(self) -> int:
        n = self.traffic["rooms_per_batch"]
        return int(self.meta["config"][n]) if isinstance(n, str) else int(n)


def applies(metric: dict, cell_name: str, bench: dict) -> bool:
    """Whether `metric` is reported in a cell: its `workloads`, or, without
    that key, every cell that reports the end-to-end metric it moves (or
    every cell, for an end-to-end metric without the key)."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    target = next(m for m in bench["end_to_end"] if m["name"] == moves)
    return applies(target, cell_name, bench)


def find_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    base = os.path.join(root, "perfbench")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name,
        meta=load_json(root, cfg_entry["file"]),
        traffic=load_json(base, "traffic", w["traffic"] + ".json"),
        limits=load_json(base, "limits", name + ".json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name, bench)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name, bench)])


def reader(metric_name: str, root: str = ROOT):
    """The `read(trace)` of perfbench/metrics/<metric_name>.py, or where
    that file is absent of the reader of its measure, the name before its
    first dot (perfbench/metrics/mfu.py reads mfu.train and mfu.eval; the
    metric's `workloads` choose the cells)."""
    base = os.path.join(root, "perfbench", "metrics")
    path = os.path.join(base, metric_name + ".py")
    if not os.path.exists(path):
        path = os.path.join(base, metric_name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """The modules loaded in this process whose top-level name is jax,
    jaxlib, flax or pcf_tpu."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def cache_dirs(root: str = ROOT) -> None:
    """Fixed build-cache directories inside the checkout for any extension
    or Triton build; the program's own kernels build into pcf_torch/_build/."""
    base = os.path.join(root, "_perfbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


# -------------------------------------------------------------------- inputs


def rooms(cell: Cell, seed: int) -> list:
    """The pool's level-0 scenes (coord, colour, normal, label), in the
    run's order: a fixed set of rooms, permuted by the seed."""
    from perfbench.rooms import level0, make_room

    t = cell.traffic
    n = cell.batch_size * t["pool_batches"]
    order = np.random.default_rng(int(seed)).permutation(n)
    grid0 = cell.meta["config"]["grid_size"][0]
    made = [level0(*make_room(t["room_seed_base"] + i, t["room_points"],
                              cell.meta["config"]["num_classes"]), grid0)
            for i in range(n)]
    return [made[i] for i in order], [t["room_seed_base"] + int(i) for i in order]


def program_items(cfg, scenes, room_seeds) -> list:
    """Each scene through the program's host pipeline: the full pyramid with
    edges, or under post_knn the pyramid without them."""
    from pcf_torch.data.pyramid import scene_to_item, subsample

    items = []
    for (coord, color, norm, label), rs in zip(scenes, room_seeds):
        if cfg.get("post_knn"):
            pts, nrm = subsample(coord, norm, grid_size=cfg.grid_size)
            items.append({"point_list": pts, "surface_normal_list": nrm,
                          "feature_list": color, "label_list": label})
        else:
            items.append(scene_to_item(coord, norm, color, label, cfg.grid_size,
                                       cfg.K_self, cfg.K_forward, cfg.K_propagate,
                                       rng=np.random.default_rng(rs),
                                       morton=bool(cfg.get("window_gather"))))
    return items


def pack_pool(cfg, items, canonical, batch_size: int):
    """(batches, level caps): the pool packed batch by batch under caps that
    hold any batch_size of the pool's scenes (estimated over all of them in
    the rooms' canonical order, so every seed gets the same shapes), and
    window sizes estimated the same way."""
    from pcf_torch.core.batching import pack_scenes
    from pcf_torch.data.scannet import estimate_level_caps, estimate_window_sizes

    ordered = [items[i] for i in canonical]
    caps = estimate_level_caps([ordered], batch_size, cfg.bucket_multiple,
                               sample=len(ordered), margin=cfg.level_caps_margin,
                               seed=cfg.manual_seed)
    windows = None
    if cfg.get("window_gather"):
        windows = estimate_window_sizes([ordered], sample=len(ordered),
                                        margin=cfg.window_margin, tile=cfg.window_tile,
                                        seed=cfg.manual_seed)
    batches = [pack_scenes(items[b:b + batch_size], level_caps=caps,
                           bucket_multiple=cfg.bucket_multiple,
                           ignore_label=cfg.ignore_label,
                           window_tile=cfg.window_tile if cfg.get("window_gather") else None,
                           window_sizes=windows)
               for b in range(0, len(items), batch_size)]
    return batches, caps


# ----------------------------------------------------------------- the run


@dataclass
class Record:
    """What the window and the set-up leave for the check and the readers."""

    steps: int = 0
    points: int = 0
    batch_ids: list = field(default_factory=list)
    latencies: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    preds: dict = field(default_factory=dict)
    logits: dict = field(default_factory=dict)
    repeat_mismatch: int = 0
    step_events: list = field(default_factory=list)
    prep_events: list = field(default_factory=list)
    prep_edges: list = field(default_factory=list)


def _pinned(batch):
    """The batch in page-locked host memory, as a loader with pin_memory
    hands it: the copy-in is one DMA per tensor, not a staged copy."""
    import dataclasses

    def pin(x):
        if isinstance(x, tuple):
            return tuple(pin(v) for v in x)
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: pin(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        return x.pin_memory()

    return pin(batch)


def _valid_points(batch) -> int:
    return int(batch.masks[0].sum())


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float | None = None, fault: str | None = None, log=print) -> dict:
    """One run; returns {"result": the result line's JSON object, "checks":
    [(name, value, limit)], ...}. `device` is the card, or "cpu" for the
    harness's own tests (never from perfbench/run.py). `fault`, for those
    tests only, plants one under the timed path: "frozen_state" (a train
    step that leaves the parameters as they were), "half_batch" (half of
    each batch left out: every other scene masked out in training, half the
    rows' logits zeroed in evaluation) or "altered_answer" (one prediction
    changed where it is produced)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    on_card = device.type == "cuda"
    from pcf_torch.config import Config, get_default_configs, get_default_training_cfgs
    from pcf_torch.utils.cache import enable_compile_cache

    cfg = Config.from_dict(cell.cfg)
    cfg = get_default_training_cfgs(get_default_configs(cfg, cfg.num_level, cfg.base_dim))
    built = enable_compile_cache(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    scenes, room_seeds = rooms(cell, seed)
    canonical = list(np.argsort(room_seeds))
    items = program_items(cfg, scenes, room_seeds)
    batches, caps = pack_pool(cfg, items, canonical, cell.batch_size)
    if on_card:
        batches = [_pinned(b) for b in batches]
    points = [_valid_points(b) for b in batches]

    from perfbench import weights as W
    from pcf_torch.models import PointConvFormer_Segmentation

    w0 = W.draw(cell.cfg, seed, device)
    model = PointConvFormer_Segmentation(cfg).to(device)
    W.to_program(w0, model)

    rec = Record()
    calls = _CallRecorder() if trace else None
    train = cell.traffic["loop"] == "train"
    if train:
        advance, program_state = _train_setup(cell, cfg, model, batches, scenes, seed,
                                              device, rec, calls, fault, log)
    else:
        advance, program_state = _eval_setup(cell, cfg, model, batches, device, rec,
                                             calls, fault, log)
    setup_s = time.perf_counter() - t_start
    log(f"[setup] {setup_s:.3f} s; native pipeline {built['native']}, kernels "
        f"{built['kernels']}; caps {caps}; valid points per batch {points}")

    # ---------------------------------------------------------- the window
    prof = _Profiler(cell.traffic.get("trace_steps", 10 ** 9), on_card) if trace else None
    rec.steps = rec.points = 0
    if on_card:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    if prof:
        prof.start()
    i = 0
    while time.perf_counter() - t0 < seconds:
        b = i % len(batches)
        advance(b, i, trace)
        rec.steps += 1
        rec.points += points[b]
        rec.batch_ids.append(b)
        i += 1
        if prof:
            prof.step(device)
    # the window's end: nothing more is sent; all that was is waited for and counted
    t_last = time.perf_counter()
    if hasattr(advance, "flush"):
        advance.flush()
    if on_card:
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    traced = prof.stop(device) if prof else None
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    log(f"[window] {rec.steps} steps, {rec.points} points in {window_s:.3f} s, "
        f"{window_s - (t_last - t0):.3f} s of them after the last was sent")

    # ---------------------------------------------------------- the check
    from perfbench import check

    step_times = _event_ms(rec.step_events)
    prep_times = _event_ms(rec.prep_events)
    program_out = program_state()
    del model, advance, program_state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, readings = check.judge(cell, scenes, batches, w0, rec, program_out, device, log)
    correct = all(v <= lim for _, v, lim in checks)

    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": _end_to_end(m["name"], rec, window_s, setup_s),
                                  "unit": m["unit"]}
    else:
        t = _trace_view(cell, cfg, batches, rec, traced, window_s, step_times, prep_times,
                        calls, device)
        for m in cell.per_layer:
            v = reader(m["name"])(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        device_info["busy_s"] = traced["busy_s"] if traced else 0.0
        device_info["window_s"] = traced["window_s"] if traced else window_s
    result = {"correct": bool(correct), "attempted": rec.steps,
              "failed": 0 if correct else rec.steps, "metrics": metrics,
              "device": device_info}
    if trace and traced:
        result["breakdown"] = traced["breakdown"]
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return {"result": result, "checks": checks, "readings": readings, "window_s": window_s,
            "setup_s": setup_s}


def _end_to_end(name: str, rec: Record, window_s: float, setup_s: float) -> float:
    if name == "setup_s":
        return setup_s
    if name in ("train_points_per_s", "eval_points_per_s"):
        return rec.points / window_s
    if name == "eval_batch_ms_p95":
        ms = [x * 1e3 for x in rec.latencies]
        return statistics.quantiles(ms, n=20)[-1] if len(ms) > 1 else ms[0]
    raise KeyError(f"no end-to-end metric {name!r} in the harness")


def _event_ms(pairs) -> list:
    out = []
    for a, b in pairs:
        out.append(a.elapsed_time(b) if hasattr(a, "elapsed_time") else b - a)
    return out


def _stamp(on_card: bool):
    if on_card:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    return time.perf_counter() * 1e3


def _annotate(trace: bool, name: str):
    from contextlib import nullcontext

    return torch.profiler.record_function(name) if trace else nullcontext()


# -------------------------------------------------------------- training


def _train_setup(cell, cfg, model, batches, scenes, seed, device, rec, calls, fault, log):
    """(advance, program_state): advance(b, i, trace) runs one step on pool
    batch b, the window's own call; program_state() hands the check what
    the warm steps left (losses, the first gradient as AdamW holds it, the
    parameters after the warm steps) once the window has closed."""
    from pcf_torch.data.post_knn import make_prepare
    from pcf_torch.data.scannet import compute_weight
    from pcf_torch.parallel.mesh import make_train_step, step_seed
    from pcf_torch.train.state import create_train_state, make_optimizer

    on_card = device.type == "cuda"
    tx, _ = make_optimizer(cfg, int(cell.meta["assumed"]["iter_per_epoch"]))
    state = create_train_state(model, tx)
    weights = compute_weight([s[3] for s in scenes], cfg.num_classes)
    step = make_train_step(cfg, class_weights=weights)
    prep = make_prepare(cfg) if cfg.get("post_knn") else None
    box = {"state": state, "metrics": None, "prep_out": None}

    def advance(b, i, trace):
        batch = batches[b]
        if fault == "half_batch":
            batch = _half_scenes(batch, cfg.ignore_label)
        with _annotate(trace, "copy_in"):
            dev = batch.to(device)
        if prep is not None:
            e0 = _stamp(on_card) if trace else None
            with _annotate(trace, "prepare"):
                dev = prep(dev, device)
            if trace:
                rec.prep_events.append((e0, _stamp(on_card)))
            box["prep_out"] = dev
        e0 = _stamp(on_card) if trace else None
        before = ([p.detach().clone() for p in model.parameters()]
                  if fault == "frozen_state" else None)
        with _annotate(trace, "train_step"):
            box["state"], box["metrics"] = step(box["state"], dev, step_seed(seed, i))
        if trace:
            rec.step_events.append((e0, _stamp(on_card)))
        if before is not None:
            with torch.no_grad():
                for p, q in zip(model.parameters(), before):
                    p.copy_(q)

    # The first call of a step signature runs the step eagerly and captures
    # it (parallel/graphs.py); every later call replays the graph. Set-up
    # makes that first call once, on batch 0, and then puts the model and
    # the optimizer back as they were, in place (a graph reads them at their
    # addresses): the warm steps that the check follows are replays, as each
    # step of the window is. A hook copies the model's logits into one
    # buffer; captured with the step, the copy runs in every replay.
    logits = {}

    def keep_logits(module, args, out):
        if "buf" in logits:
            logits["buf"].copy_(out.detach())
        else:
            logits["buf"] = out.detach().clone()

    hook = model.register_forward_hook(keep_logits)
    params0 = [p.detach().clone() for p in model.parameters()]
    buffers0 = [b.detach().clone() for b in model.buffers()]
    if calls is not None:
        with calls:
            advance(0, 0, False)
    else:
        advance(0, 0, False)
    _restore(box["state"], params0, buffers0)
    hook.remove()
    del params0, buffers0

    warm = int(cell.traffic["warm_steps"])
    for i in range(warm):
        advance(i % len(batches), i, False)
        rec.losses.append(float(box["metrics"]["loss"]))
        if prep is not None:
            out = box["prep_out"]
            rec.prep_edges.append({k: [e.cpu() for e in getattr(out, k)] for k in
                                   ("edges_self", "edges_forward", "edges_propagate")})
        if i == 0:
            beta1 = tx.inner.param_groups[0]["betas"][0]
            g1 = [(tx.inner.state[p]["exp_avg"] / (1 - beta1)).clone() for p in tx.params]
            raw1 = [p.grad.detach().clone() for p in tx.params]
            logits1 = logits["buf"].clone()
            stats1 = {n: b.detach().clone() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))}
    after = [p.detach().clone() for p in model.parameters()]
    log(f"[warm] losses {rec.losses}; captures {_captures(step, prep)}")
    names = [n for n, _ in model.named_parameters()]

    def program_state():
        return {"names": names, "g1": dict(zip(names, g1)), "raw1": dict(zip(names, raw1)),
                "after": dict(zip(names, after)), "losses": list(rec.losses),
                "prep_edges": rec.prep_edges, "stats1": stats1, "logits1": logits1}

    return advance, program_state


def _restore(state, params0, buffers0) -> None:
    """The train state as it was before its first step, every tensor kept
    at its address: parameters and buffers copied back, the optimizer's
    moments and step counts zeroed, the host's counts reset."""
    model, tx = state.model, state.tx
    with torch.no_grad():
        for p, q in zip(model.parameters(), params0):
            p.copy_(q)
        for b, q in zip(model.buffers(), buffers0):
            b.copy_(q)
        for p in tx.params:
            for v in tx.inner.state.get(p, {}).values():
                if isinstance(v, torch.Tensor):
                    v.zero_()
    tx.count = 0
    state.step = 0


def _captures(*fns) -> list:
    """(capture ms, pool MiB) of every graph the steps hold: what set-up
    pays for its captures."""
    out = []
    for fn in fns:
        for entry in getattr(getattr(fn, "graphs", None), "entries", {}).values():
            out.append((round(entry.capture_ms, 1), round(entry.pool_bytes / 2 ** 20, 1)))
    return out


def _half_scenes(batch, ignore):
    """The batch with every other scene left out: its rows masked at every
    level and its labels ignored, so statistics and loss see the rest."""
    import dataclasses

    keep = [(b >= 0) & (b % 2 == 0) for b in batch.bids]
    labels = torch.where(keep[0], batch.labels, torch.full_like(batch.labels, ignore))
    return dataclasses.replace(batch, labels=labels,
                               masks=tuple(m & k for m, k in zip(batch.masks, keep)))


# -------------------------------------------------------------- evaluation


def _eval_setup(cell, cfg, model, batches, device, rec, calls, fault, log):
    from pcf_torch.parallel.mesh import make_eval_step

    on_card = device.type == "cuda"
    step = make_eval_step(cfg)
    with torch.no_grad():
        model.train()
        for k in range(int(cell.traffic["calibration_passes"])):
            model.forward_batch(batches[k % len(batches)].to(device))
        model.eval()
    first_preds = {}
    # batches dispatched and not yet seen on the host: (pool batch, host
    # buffer of its predictions, event after their copy, dispatch time)
    ahead = int(cell.traffic.get("ahead_batches", 1))
    pending, free = deque(), []

    def advance(b, i, trace):
        t = time.perf_counter()
        e0 = _stamp(on_card) if trace else None
        with _annotate(trace, "eval_step"):
            # the pool's pinned batch: the step copies it into its graph's inputs
            logits = step(model, batches[b])
        if trace:
            rec.step_events.append((e0, _stamp(on_card)))
        if fault == "half_batch":
            logits = logits.clone()
            logits[1::2] = 0
        with _annotate(trace, "predictions_to_host"):
            pred = logits.argmax(-1)
            if fault == "altered_answer":
                pred[0] = (pred[0] + 1) % logits.shape[-1]
            if not free:
                free.append(torch.empty(pred.shape, dtype=pred.dtype, pin_memory=on_card))
            host = free.pop()
            host.copy_(pred, non_blocking=on_card)
            done = None
            if on_card:
                done = torch.cuda.Event()
                done.record()
        rec.logits[b] = logits
        pending.append((b, host, done, t))
        while len(pending) >= ahead:
            finish(*pending.popleft())

    def finish(b, host, done, t):
        """Wait for batch b's predictions on the host and keep them."""
        if done is not None:
            done.synchronize()
        rec.latencies.append(time.perf_counter() - t)
        pred = host.clone()
        free.append(host)
        if b in first_preds:
            rec.repeat_mismatch += int(not torch.equal(first_preds[b], pred))
        else:
            first_preds[b] = pred
        rec.preds[b] = pred

    def flush():
        while pending:
            finish(*pending.popleft())

    with torch.no_grad():
        if calls is not None:
            with calls:
                advance(0, 0, False)
        for i in range(3):
            advance(i % len(batches), i, False)
        flush()
    # a host buffer for every batch that may be in flight, made before the window
    if ahead > len(free):
        free.extend(torch.empty((ahead - len(free),) + tuple(free[0].shape),
                                dtype=free[0].dtype, pin_memory=on_card).unbind(0))
    rec.latencies.clear()
    rec.preds.clear()
    log(f"[warm] captures {_captures(step)}; {ahead} batches may be in flight")
    rec.logits.clear()
    first_preds.clear()

    def program_state():
        return {"running": {n: b.detach().clone() for n, b in model.named_buffers()}}

    def advance_nograd(b, i, trace):
        with torch.no_grad():
            advance(b, i, trace)

    advance_nograd.flush = flush
    return advance_nograd, program_state


# ------------------------------------------------------------------ trace


class _CallRecorder(torch.utils._python_dispatch.TorchDispatchMode):
    """The shapes of every call of the program's kernel operators
    (pcf::conv_linear, pcf::window_resolve, pcf::window_resolve_flat)
    during one eager step, outside any CUDA graph capture."""

    OPS = ("conv_linear", "window_resolve", "window_resolve_flat")

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "_schema", None)
        name = name.name if name is not None else str(func)
        if name.startswith("pcf::") and name[5:] in self.OPS and not (
                torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
            self.calls.append((name[5:], _shapes(args)))
        return func(*args, **(kwargs or {}))


def _shapes(args):
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append((tuple(a.shape), a.element_size()))
        else:
            out.append(a)
    return out


class _Profiler:
    """torch.profiler over the first `limit` steps of the window (or all of
    it): the device's kernels and copies with their times, and the host's
    annotations."""

    def __init__(self, limit: int, on_card: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        self.prof = profile(activities=acts)
        self.limit, self.n, self.on = limit, 0, False

    def start(self):
        self.prof.__enter__()
        self.on = True
        self.t0 = time.perf_counter()

    def step(self, device):
        if self.on:
            self.n += 1
            if self.n >= self.limit:
                self._close(device)

    def _close(self, device):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.on = False

    def stop(self, device) -> dict:
        if self.on:
            self._close(device)
        return summarize(self.prof, self.n, self.t1 - self.t0)


def summarize(prof, steps: int, wall_s: float) -> dict:
    """From a finished profile: the device's intervals, busy seconds (their
    union), kernel seconds by name, the longest idle gaps named by the
    host annotation open at their start, and the traced window."""
    events = prof.profiler.kineto_results.events()
    dev, host = [], []
    for e in events:
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.name() not in ANNOTATIONS:  # the device-side copies of the host's spans
                dev.append((start, start + dur, e.name()))
        elif e.is_user_annotation() if hasattr(e, "is_user_annotation") else False:
            host.append((start, start + dur, e.name()))
    dev.sort()
    by_name, busy, gaps = {}, 0, []
    cur_s = cur_e = None
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0) + (e - s)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                gaps.append((s - cur_e, cur_e))
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = (dev[-1][1] - dev[0][0]) if dev else 0
    window_s = max(wall_s, span / 1e9)
    host.sort()

    def doing(t):
        best = None
        for s, e, n in host:
            if s <= t < e and n in ANNOTATIONS:
                best = n
        return best or "between calls"

    gaps.sort(reverse=True)
    named = {}
    for g, at in gaps:
        k = doing(at)
        named[k] = named.get(k, 0) + g
    top_gaps = [[f"{doing(at)} (gap of {g / 1e6:.3f} ms)", g / 1e9] for g, at in gaps[:10]]
    return {"busy_s": busy / 1e9, "window_s": window_s, "steps": steps,
            "kernel_s": {n: v / 1e9 for n, v in by_name.items()},
            "idle_by_host": {n: v / 1e9 for n, v in named.items()},
            "breakdown": {"device_ops": [[n, v / 1e9] for n, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:10]], "idle_gaps": top_gaps}}


@dataclass
class TraceView:
    """What a per-layer metric reads (perfbench/metrics/*.py)."""

    loop: str
    dtype: str
    traced: dict | None
    window_s: float
    steps: int
    step_ms: list
    prep_ms: list
    calls: list
    step_flops: list


def _trace_view(cell, cfg, batches, rec, traced, window_s, step_times, prep_times, calls,
                device) -> TraceView:
    """The traced window's facts, with the network's operations of each
    step it holds (the reference's count at each batch's real level
    sizes)."""
    from perfbench.reference.flops import step_flops

    train = cell.traffic["loop"] == "train"
    n = traced["steps"] if traced else rec.steps
    per_batch = {}
    for b, batch in enumerate(batches):
        sizes = [int(m.sum()) for m in batch.masks]
        per_batch[b] = step_flops(cell.cfg, sizes, train)
    flops = [per_batch[b] for b in rec.batch_ids[:n]]
    return TraceView(loop=cell.traffic["loop"], dtype=cell.meta["dtype"], traced=traced,
                     window_s=traced["window_s"] if traced else window_s, steps=n,
                     step_ms=step_times, prep_ms=prep_times,
                     calls=calls.calls if calls is not None else [], step_flops=flops)
