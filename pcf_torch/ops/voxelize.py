"""Host-side voxel selection for the input pipeline (numpy), the port of
pcf_tpu/ops/voxelize.py: the same Generator draws give the same indices.

Serves the same three roles as the reference's util/voxelize.py:44-82: pick
one point per occupied voxel for training ('random'), a reproducible
representative ('deterministic'), or covering index sets for evaluation
('multiple', every raw point predicted at least once). Points are binned
with an exact (collision-free) linear cell index and grouped with one
stable argsort, so intra-voxel order is the original point order.
"""

from __future__ import annotations

import numpy as np


def voxel_cell_ids(coord: np.ndarray, voxel_size: float | np.ndarray) -> np.ndarray:
    """Exact linear cell index of each point: [N] int64.

    Cells are the integer lattice of floor(coord / voxel_size), shifted to
    start at 0 and raveled C-style over the occupied bounding box. Unlike a
    hash, equal ids <=> same voxel, always.
    """
    cells = np.floor(coord / np.asarray(voxel_size)).astype(np.int64)
    cells -= cells.min(axis=0)
    dims = cells.max(axis=0) + 1
    strides = np.ones_like(dims)
    strides[:-1] = np.cumprod(dims[::-1])[-2::-1]
    return cells @ strides


def _group_by_voxel(coord, voxel_size):
    """Stable grouping: returns (order, starts, counts) where
    order[starts[v]:starts[v]+counts[v]] are the input indices of voxel v,
    in original point order."""
    ids = voxel_cell_ids(coord, voxel_size)
    order = np.argsort(ids, kind="stable")
    _, starts, counts = np.unique(ids[order], return_index=True, return_counts=True)
    return order, starts, counts


def voxelize(
    coord: np.ndarray,
    voxel_size: float | np.ndarray = 0.05,
    hash_type: str = "exact",  # accepted for reference-YAML compat; unused
    mode: str = "random",
    rng: np.random.Generator | None = None,
):
    """Representative point indices per occupied voxel.

    mode='random': one uniformly random point per voxel (training; the
      reference draws max-then-mod which is slightly biased — here the draw
      is exact per-voxel uniform).
    mode='deterministic': the lowest original index per voxel.
    mode='multiple': a list of index arrays that jointly cover every point;
      set i holds each voxel's (i mod count)-th point (evaluation,
      reference behavior util/voxelize.py:71-77).
    """
    order, starts, counts = _group_by_voxel(coord, voxel_size)
    if mode == "deterministic":
        # stable grouping => position `starts` is the first-seen point
        return order[starts]
    if mode == "multiple":
        return [order[starts + i % counts] for i in range(int(counts.max()))]
    rng = rng or np.random.default_rng()
    return order[starts + rng.integers(0, counts)]
