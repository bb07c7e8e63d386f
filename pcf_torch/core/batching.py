"""Static-shape packed batching for variable-size point-cloud pyramids.

Every pyramid level of a multi-scene batch is padded to a bucketed capacity
and carries a validity mask and per-point scene ids; padded rows have
neighbour index 0 and label = ignore_label. The arrays are those of
pcf_tpu/core/batching.py, emitted as torch tensors on the CPU; `.to(device)`
moves a whole batch (and may cast its floating-point arrays).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Sequence

import numpy as np
import torch

from pcf_torch.ops.window import WindowedEdges, build_windows


@dataclass
class PackedPyramid:
    """One packed, padded multi-scene batch.

    feats: [N0, C]; labels: [N0] int32; per level l:
    points[l] [Nl, 3], norms[l] [Nl, 3], masks[l] [Nl] bool, bids[l] [Nl] int32,
    edges_self[l] [Nl, K]; edges_forward[l] [N(l+1), K] (into level l);
    edges_propagate[l] [Nl, K] (into level l+1). Edges are int32 tensors or
    WindowedEdges.
    """

    feats: torch.Tensor
    labels: torch.Tensor
    points: tuple
    norms: tuple
    masks: tuple
    bids: tuple
    edges_self: tuple
    edges_forward: tuple
    edges_propagate: tuple

    def to(self, device, dtype: torch.dtype | None = None) -> "PackedPyramid":
        """The batch on `device`; with `dtype`, its floating-point arrays
        (features, points, normals) cast to it."""
        def move(x):
            if isinstance(x, tuple):
                return tuple(move(v) for v in x)
            if dtype is not None and isinstance(x, torch.Tensor) and x.is_floating_point():
                return x.to(device, dtype)
            return x.to(device)

        return PackedPyramid(**{f.name: move(getattr(self, f.name))
                                for f in fields(self)})


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def compute_level_caps(level_sizes: Sequence[int], bucket_multiple: int = 8192,
                       min_cap: int = 256) -> list[int]:
    """Bucketed per-level capacities: each level's packed size rounded up to
    a multiple of the bucket, or to a power of two times min_cap below it."""
    caps = []
    for s in level_sizes:
        m = max(min_cap, bucket_multiple)
        if s <= min_cap:
            caps.append(min_cap)
        elif s < m:
            c = min_cap
            while c < s:
                c *= 2
            caps.append(c)
        else:
            caps.append(round_up(s, m))
    return caps


def _pad_rows(arr: np.ndarray, cap: int, value=0) -> np.ndarray:
    pad = [(0, cap - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=value)


def pack_scenes(
    scenes: Sequence[dict],
    level_caps: Sequence[int] | None = None,
    bucket_multiple: int = 8192,
    ignore_label: int = -100,
    window_tile: int | None = None,
    window_size: int | None = None,
    window_sizes: Sequence[int] | None = None,
) -> PackedPyramid:
    """Pack per-scene pyramids (dicts from data.pyramid.scene_to_item) into
    one padded batch.

    window_tile set (e.g. 128) wraps every edge array in a WindowedEdges;
    the scenes must then be Morton-sorted per level (scene_to_item(morton=
    True)), and every scene's segment is aligned to the tile so that no tile
    straddles two scenes. `window_sizes` gives the (self, forward, propagate)
    window sizes, default (768, 1536, 512); `window_size` forces one size.
    """
    n_levels = len(scenes[0]["point_list"])
    align = window_tile if window_tile else 1

    def _seg_sizes(lvl):
        return [round_up(s["point_list"][lvl].shape[0], align) for s in scenes]

    sizes = [sum(_seg_sizes(lvl)) for lvl in range(n_levels)]
    if level_caps is None:
        level_caps = compute_level_caps(sizes, bucket_multiple)
    assert all(c >= s for c, s in zip(level_caps, sizes)), (level_caps, sizes)

    def _cat_aligned(arrs, lvl, value=0):
        segs = [_pad_rows(np.asarray(a), sz, value=value)
                for a, sz in zip(arrs, _seg_sizes(lvl))]
        return np.concatenate(segs, 0)

    points, norms, masks, bids = [], [], [], []
    edges_self, edges_forward, edges_propagate = [], [], []
    has_edges = "nei_self_list" in scenes[0]
    if not has_edges:
        raise NotImplementedError(
            "scenes without edges (post_knn) are not supported by pcf_torch yet")

    for lvl in range(n_levels):
        seg = _seg_sizes(lvl)
        offs = np.cumsum([0] + seg)
        pts = _cat_aligned([s["point_list"][lvl] for s in scenes],
                           lvl).astype(np.float32)
        nrm = _cat_aligned([s["surface_normal_list"][lvl] for s in scenes],
                           lvl).astype(np.float32)
        bid = _cat_aligned(
            [np.full(s["point_list"][lvl].shape[0], i, np.int32)
             for i, s in enumerate(scenes)], lvl, value=-1)
        cap = level_caps[lvl]
        mask = np.zeros(cap, bool)
        mask[: bid.shape[0]] = bid >= 0
        # padded coords are 0, never a far-away sentinel: masks and scene
        # ids keep padding out of statistics and neighbourhoods
        points.append(_pad_rows(pts, cap, value=0.0))
        norms.append(_pad_rows(nrm, cap))
        masks.append(mask)
        bids.append(_pad_rows(bid, cap, value=-1))

        es = _cat_aligned(
            [s["nei_self_list"][lvl] + offs[i] for i, s in enumerate(scenes)],
            lvl).astype(np.int32)
        edges_self.append(_pad_rows(es, cap))
        if lvl < n_levels - 1:
            ef = _cat_aligned(
                [s["nei_forward_list"][lvl] + offs[i]
                 for i, s in enumerate(scenes)], lvl + 1).astype(np.int32)
            edges_forward.append(_pad_rows(ef, level_caps[lvl + 1]))
            offs_next = np.cumsum([0] + _seg_sizes(lvl + 1))
            ep = _cat_aligned(
                [s["nei_propagate_list"][lvl] + offs_next[i]
                 for i, s in enumerate(scenes)], lvl).astype(np.int32)
            edges_propagate.append(_pad_rows(ep, cap))

    if window_tile:
        ws, wf, wp = window_sizes or (768, 1536, 512)
        if window_size:
            ws = wf = wp = window_size

        def _edges(arrs, w):
            return tuple(build_windows(a, tile=window_tile, window=w)
                         for a in arrs)
    else:
        def _edges(arrs, w):
            return tuple(torch.from_numpy(a) for a in arrs)
        ws = wf = wp = None

    feats = _cat_aligned([s["feature_list"] for s in scenes], 0).astype(np.float32)
    if "label_list" in scenes[0]:
        labels = _cat_aligned(
            [np.asarray(s["label_list"]).reshape(-1) for s in scenes], 0,
            value=ignore_label).astype(np.int32)
    else:
        labels = np.full(sizes[0], ignore_label, np.int32)
    labels = _pad_rows(labels.reshape(-1), level_caps[0], value=ignore_label)

    def _tensors(arrs):
        return tuple(torch.from_numpy(a) for a in arrs)

    return PackedPyramid(
        feats=torch.from_numpy(_pad_rows(feats, level_caps[0])),
        labels=torch.from_numpy(labels),
        points=_tensors(points),
        norms=_tensors(norms),
        masks=_tensors(masks),
        bids=_tensors(bids),
        edges_self=_edges(edges_self, ws),
        edges_forward=_edges(edges_forward, wf),
        edges_propagate=_edges(edges_propagate, wp),
    )


__all__ = ["PackedPyramid", "WindowedEdges", "compute_level_caps",
           "pack_scenes", "round_up"]
