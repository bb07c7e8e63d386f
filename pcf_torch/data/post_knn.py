"""The pyramid and kNN built on the device after batching: the port of
pcf_tpu/data/post_knn.py.

cfg.post_knn: the host ships the grid-subsampled pyramid without edges, and
the three edge sets per level are computed on the batch's device
(compute_knn_packed). cfg.device_pyramid: the host ships level 0 alone, and
the grid subsampling of every higher level runs on the device too
(build_pyramid_packed). Both work on the packed layout directly: batch ids
keep every neighbourhood within its scene.

make_prepare is the trainer's and the evaluations' form: on the card it
captures the preparation once per batch signature as a CUDA graph
(parallel/graphs.StepGraphs), as pcf_tpu jit-compiles it once per shape.
"""

from __future__ import annotations

import dataclasses

import torch

from pcf_torch.core.batching import PackedPyramid
from pcf_torch.ops.kernels import knn_scene
from pcf_torch.ops.knn import knn
from pcf_torch.ops.subsample import grid_subsample_fixed
from pcf_torch.parallel.graphs import StepGraphs
from pcf_torch.utils.trace import span


def compute_knn_packed(batch: PackedPyramid, k_self: tuple, k_forward: tuple,
                       k_propagate: tuple, method: str = "approx",
                       n_scenes: int | None = None) -> PackedPyramid:
    """The batch with edges_self / forward / propagate computed on its
    device. method "approx" computes the exact kNN (ops/knn.py). On a card
    each level's rows are grouped by scene once as references and once as
    queries (ops/kernels/knn_scene.group) for the edge sets that read them;
    n_scenes bounds the scene ids there (default: the largest level's rows)."""
    if method not in ("exact", "approx"):
        raise ValueError(f"compute_knn_packed: unknown method {method!r}")
    pts, bids, masks = batch.points, batch.bids, batch.masks
    n_levels = len(pts)
    if pts[0].device.type == "cuda":
        S = n_scenes if n_scenes is not None else max(p.shape[0] for p in pts)
        refs = [knn_scene.group(pts[i], bids[i], masks[i], S) for i in range(n_levels)]
        queries = [knn_scene.group(pts[i], bids[i], None, S) for i in range(n_levels)]

        def edges(q, r, k):
            return knn_scene.search(queries[q], refs[r], int(k), self_search=q == r)
    else:
        def edges(q, r, k):
            return knn(pts[q], pts[r], int(k), query_bid=bids[q], ref_bid=bids[r],
                       ref_mask=masks[r], method=method)

    edges_self, edges_forward, edges_propagate = [], [], []
    for lvl in range(n_levels):
        edges_self.append(edges(lvl, lvl, k_self[lvl]))
        if lvl < n_levels - 1:
            # forward: queries at level l+1, refs at level l
            edges_forward.append(edges(lvl + 1, lvl, k_forward[lvl + 1]))
            # propagate: queries at level l, refs at level l+1
            edges_propagate.append(edges(lvl, lvl + 1, k_propagate[lvl]))
    return dataclasses.replace(batch, edges_self=tuple(edges_self),
                               edges_forward=tuple(edges_forward),
                               edges_propagate=tuple(edges_propagate))


def build_pyramid_packed(batch: PackedPyramid, grid_sizes: tuple, level_caps: tuple,
                         n_scenes: int, k_self: tuple, k_forward: tuple,
                         k_propagate: tuple, method: str = "approx"):
    """(full batch, overflow): every level above the packed level 0 grid-
    subsampled on the device into level_caps[l] rows (normals averaged and
    renormalised), then all three edge sets. overflow is a 0-d bool tensor,
    True when a level had more voxels than its cap: the result is then not
    valid."""
    points, norms = [batch.points[0]], [batch.norms[0]]
    masks, bids = [batch.masks[0]], [batch.bids[0]]
    overflow = torch.zeros((), dtype=torch.bool, device=batch.points[0].device)
    for lvl in range(1, len(grid_sizes)):
        sub = grid_subsample_fixed(points[-1], masks[-1], float(grid_sizes[lvl]),
                                   int(level_caps[lvl]), features=norms[-1], bid=bids[-1],
                                   n_scenes=n_scenes)
        nrm = sub["feats"]
        nrm = nrm / nrm.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        points.append(sub["points"])
        norms.append(nrm)
        masks.append(sub["mask"])
        bids.append(sub["bid"])
        overflow = overflow | sub["overflow"]
    full = dataclasses.replace(batch, points=tuple(points), norms=tuple(norms),
                               masks=tuple(masks), bids=tuple(bids))
    return compute_knn_packed(full, k_self, k_forward, k_propagate, method=method,
                              n_scenes=n_scenes), overflow


def device_level_caps(cfg, cap0: int) -> tuple:
    """Per-level caps of the device pyramid: cfg.device_level_caps, or each
    level's cap the last one over cfg.device_cap_shrink (default 2.8),
    rounded up to 128 and at least 256. The shrink suits dense scans; the
    voting evaluator sets caps from a host count instead (eval/voting.py),
    and the overflow flag stays the safety net."""
    if cfg.get("device_level_caps"):
        return tuple(int(c) for c in cfg.device_level_caps)
    shrink = float(cfg.get("device_cap_shrink", 2.8))
    caps = [cap0]
    for _ in range(1, len(cfg.grid_size)):
        caps.append(max(256, -(-int(caps[-1] / shrink) // 128) * 128))
    return tuple(caps)


def _ks(cfg) -> tuple:
    n = len(cfg.grid_size)

    def k(v):
        return tuple(int(x) for x in v) if isinstance(v, (list, tuple)) else (int(v),) * n

    return k(cfg.get("K_self", 16)), k(cfg.get("K_forward", 16)), k(cfg.get("K_propagate", 16))


def static_args(cfg, cap0: int) -> tuple:
    """What the preparation of a batch whose level 0 has cap0 rows reads
    from cfg, as one hashable key: the mode, then for device_pyramid the
    grid sizes, the caps and the scene count, for post_knn the scene count
    (None without cfg.BATCH_SIZE), then the k's and the method."""
    ks = _ks(cfg) + (cfg.get("knn_method", "approx"),)
    if cfg.get("device_pyramid"):
        return ("device_pyramid", tuple(float(g) for g in cfg.grid_size),
                device_level_caps(cfg, cap0), int(cfg.BATCH_SIZE)) + ks
    scenes = cfg.get("BATCH_SIZE")
    return ("post_knn", None if scenes is None else int(scenes)) + ks


def prepare_flagged(batch: PackedPyramid, cfg):
    """(full batch, overflow flag or None), the flag left on the device.
    device_pyramid: build_pyramid_packed, whose scene count is
    cfg.BATCH_SIZE; post_knn: compute_knn_packed, with the same scene
    count, and None."""
    args = static_args(cfg, batch.points[0].shape[0])
    if args[0] == "device_pyramid":
        return build_pyramid_packed(batch, *args[1:])
    return compute_knn_packed(batch, *args[2:], n_scenes=args[1]), None


def check_overflow(overflow, cfg) -> None:
    """Raise when the device pyramid overflowed a level cap and
    cfg.check_pyramid_overflow (default on) asks for the check; the flag is
    read back only then, in the span sync.overflow (utils/trace)."""
    if overflow is None or not cfg.get("check_pyramid_overflow", True):
        return
    with span("sync.overflow"):
        overflowed = bool(overflow)
    if overflowed:
        raise ValueError("device pyramid overflowed a level cap; raise "
                         "cfg.device_level_caps (or MAX_POINTS_NUM)")


def prepare(batch: PackedPyramid, cfg) -> PackedPyramid:
    """The batch with its device-built pyramid and edges (cfg.post_knn or
    cfg.device_pyramid), on the batch's device; raises on an overflowed
    pyramid (check_overflow)."""
    full, overflow = prepare_flagged(batch, cfg)
    check_overflow(overflow, cfg)
    return full


def make_prepare(cfg):
    """prep(batch, device) -> prepare's batch, made on `device`. On the card
    the preparation is captured once per (static_args, batch signature) into
    a CUDA graph and replayed after that; the batch handed back is a copy of
    the graph's outputs, and the overflow flag is read back once per batch,
    before any step sees it. `prep.graphs` is the StepGraphs. A call is the
    span prepare, with step.key, the graphs' spans, prepare.copy_out and
    sync.overflow inside it (utils/trace)."""
    graphs = StepGraphs()

    def prep(batch: PackedPyramid, device) -> PackedPyramid:
        with span("prepare"):
            return run(batch, torch.device(device))

    def run(batch, device):
        if device.type != "cuda":
            full, overflow = prepare_flagged(batch.to(device), cfg)
        else:
            with span("step.key"):
                program = ("prepare",) + static_args(cfg, batch.points[0].shape[0])
                signature = batch.signature()
            (full, overflow), _ = graphs.run(program, signature, (),
                                             lambda b: prepare_flagged(b, cfg), batch, device)
            # level 0 of the outputs is the graph's static input batch, which
            # the next call overwrites, as a replay does the rest: copies
            with span("prepare.copy_out"):
                full = full.clone()
                overflow = None if overflow is None else overflow.clone()
        check_overflow(overflow, cfg)
        return full

    prep.graphs = graphs
    return prep
