"""Spatial sharding's hook in the layers: the full tables of their gather
sources.

Under spatial (point-dimension) sharding (parallel/spatial.py) every
row-aligned tensor of a packed batch is this rank's shard of the points,
and the neighbour indices stay global. Inside `sharded_points(group)` the
conv layers (nn/layers.py) and the stage geometry (models/backbone.py)
all-gather the tensors they gather rows from, once per layer
(spatial_full: pcf_tpu/nn/layers.py:82-95, its _spatial_full, which reads cfg.spatial_axis,
set inside pcf_tpu's shard_map); centres, shortcuts and outputs stay
sharded. The all-gather's backward is a reduce-scatter of the cotangent, so
the gradient of a row that another shard's edges read reaches the rank that
holds it (JAX transposes its all_gather the same way). Both collectives run
on gloo (CPU tensors) and NCCL alike.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager

import torch
import torch.distributed as dist


_POINTS: contextvars.ContextVar = contextvars.ContextVar("pcf_torch_points", default=None)


@contextmanager
def sharded_points(group):
    """Inside, the layers take their row-aligned tensors as this rank's
    shard of the points of `group`'s ranks, and all-gather their gather
    sources over it (in this thread); None: unsharded. The counterpart of
    pcf_tpu's cfg.spatial_axis, which its spatial steps set inside their
    shard_map."""
    token = _POINTS.set(group)
    try:
        yield
    finally:
        _POINTS.reset(token)


def points_group():
    """The process group of the innermost sharded_points, or None."""
    return _POINTS.get()


class _AllGatherRows(torch.autograd.Function):
    """The rows of every rank of `group`, in rank order (pcf_tpu's tiled
    all_gather). Backward: each rank's rows of the cotangent summed over
    the ranks (a reduce-scatter), so the gradient of a row that other
    shards' edges read reaches the rank that holds it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + x.shape[1:])
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // dist.get_world_size(ctx.group),) + g.shape[1:])
        dist.reduce_scatter_tensor(out, g, group=ctx.group)
        return out, None


def spatial_full(*tensors):
    """The full tables of a layer's gather sources under sharded_points (one
    all-gather each; None stays None), else the tensors themselves."""
    group = _POINTS.get()
    if group is None:
        return tensors
    return tuple(None if t is None else _AllGatherRows.apply(t, group) for t in tensors)
