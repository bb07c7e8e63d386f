"""Row gathers of the packed point layout.

Indices are clamped to the table, as jnp.take(mode="clip") does in
pcf_tpu/ops/gather.py: padded rows of a packed batch point at row 0, and a
stray index must not raise. A WindowedEdges index goes through
`windowed_take` for every dtype, which on CUDA launches the window_resolve
kernel; both paths are exact selections and give identical numbers.
"""

from __future__ import annotations

import torch

from pcf_torch.ops.window import WindowedEdges, windowed_take


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a 2-D table and int64 indices in range, through
    index_select: its backward adds into the table's gradient with
    index_add_ (pcf_tpu's scatter-add), where advanced indexing's backward
    sorts the indices and adds each one's duplicates in sequence. A packed
    batch's padded rows all point at one row, hundreds of thousands of
    duplicates at the device pyramid's size: 4.5 s of a 5 s train step on
    the H100 (PERF.md, section 6)."""
    return table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, table.shape[1])


def index_points(points: torch.Tensor, idx) -> torch.Tensor:
    """Gather rows of `points` by integer index.

      points [N, C],    idx [S] / [S, K]        -> [S, C] / [S, K, C]
      points [B, N, C], idx [B, S] / [B, S, K]  -> [B, S, C] / [B, S, K, C]

    `idx` may be a WindowedEdges (2-D points only).
    """
    if isinstance(idx, WindowedEdges):
        if points.dim() == 2:
            return windowed_take(points, idx)
        idx = idx.nei
    idx = idx.long().clamp(0, points.shape[-2] - 1)
    if points.dim() == 2:
        return take_rows(points, idx)
    batch = torch.arange(points.shape[0], device=points.device)
    return points[batch.view(-1, *([1] * (idx.dim() - 1))), idx]


def index_points_multi(tensors, idx):
    """One gather for several [N, c_i] tensors sharing the same indices.

    Tensors are grouped by dtype and concatenated along channels, so each
    group costs one gather (geometry stays f32 while features may be bf16);
    a tensor passed twice (by identity) is gathered once. Returns the
    gathered tensors in input order.
    """
    out = [None] * len(tensors)
    groups: dict = {}
    first: dict = {}
    for i, t in enumerate(tensors):
        if id(t) in first:
            continue
        first[id(t)] = i
        groups.setdefault(t.dtype, []).append(i)
    for idxs in groups.values():
        if len(idxs) == 1:
            out[idxs[0]] = index_points(tensors[idxs[0]], idx)
            continue
        g = index_points(torch.cat([tensors[i] for i in idxs], dim=-1), idx)
        off = 0
        for i in idxs:
            c = tensors[i].shape[-1]
            out[i] = g[..., off:off + c]
            off += c
    return [out[first[id(t)]] for t in tensors]
