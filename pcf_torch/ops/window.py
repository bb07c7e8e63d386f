"""Windowed dedup gather: Morton ordering, tile windows, and the resolve.

Pipeline half (numpy): each pyramid level is sorted by Morton code, so
consecutive points are spatial neighbours and a tile of Mt consecutive
output points touches few unique neighbour rows. Per tile the pipeline
stores those unique rows (`window_rows` [T, Wsz]) and each edge's position
among them (`localT` [T, 1, Mt*K]).

Device half: `windowed_take` returns table[edges.nei] by resolving every
edge through its tile's window. On CUDA it launches the window_resolve
kernel (ops/kernels/window_resolve.py); on the CPU it runs that kernel's
plain PyTorch version. Both are exact selections, equal bit for bit to
table[nei.clamp(0, N-1)]. It is differentiable in the table: the backward
is the window_scatter kernel (or its plain version), which drops the
gradient of out-of-range rows as pcf_tpu's custom VJP does.
`windowed_take_flat` is the same selection in k-major flat layout
[M, K*C], with no gradient (ops/kernels/window_resolve.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pcf_torch.ops.kernels.window_resolve import window_resolve, window_resolve_flat


# --------------------------------------------------------------------------
# Morton ordering (pipeline side)
# --------------------------------------------------------------------------

def _spread_bits(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit integers with two zero bits (uint64)."""
    x = x.astype(np.uint64) & np.uint64(0x3FF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
    return x


def morton_codes(points: np.ndarray, bits: int = 10) -> np.ndarray:
    """30-bit Morton (Z-order) codes of [N, 3] float coords (numpy)."""
    q = points - points.min(axis=0)
    scale = (1 << bits) - 1
    denom = float(q.max()) + 1e-9
    qi = np.minimum((q / denom * scale).astype(np.int64), scale)
    return (_spread_bits(qi[:, 0])
            | (_spread_bits(qi[:, 1]) << np.uint64(1))
            | (_spread_bits(qi[:, 2]) << np.uint64(2)))


def morton_argsort(points: np.ndarray) -> np.ndarray:
    """Permutation sorting [N, 3] coords into Z-order (stable)."""
    return np.argsort(morton_codes(points), kind="stable")


# --------------------------------------------------------------------------
# Window construction (pipeline side, numpy)
# --------------------------------------------------------------------------

@dataclass
class WindowedEdges:
    """A kNN edge set [M, K] plus its precomputed tile windows.

    nei:          [M, K] int32 neighbour row indices.
    window_rows:  [T, Wsz] int32, per tile of Mt = M/T output rows, the
                  deduplicated rows of `nei` that the tile touches, padded
                  with row 0.
    localT:       [T, 1, Mt*K] int32, per edge its slot in the tile's window.
    """

    nei: torch.Tensor
    window_rows: torch.Tensor
    localT: torch.Tensor

    @property
    def shape(self):
        return self.nei.shape

    def to(self, device) -> "WindowedEdges":
        return WindowedEdges(self.nei.to(device), self.window_rows.to(device),
                             self.localT.to(device))


def max_window_uniques(nei: np.ndarray, tile: int = 128) -> int:
    """Max unique-neighbour count over tiles of `tile` rows (rows are
    zero-padded to a tile multiple like packing)."""
    M, K = nei.shape
    Mp = -(-M // tile) * tile
    if Mp != M:
        nei = np.concatenate(
            [nei, np.zeros((Mp - M, K), nei.dtype)], axis=0)
    tiles = nei.reshape(Mp // tile, tile * K)
    return max(len(np.unique(t)) for t in tiles)


class WindowOverflow(ValueError):
    """A tile's unique-neighbour count exceeds the window size, or the
    array's shape is incompatible with tiling."""


def build_windows(nei: np.ndarray, tile: int = 128, window: int | None = None,
                  strict: bool = True):
    """Precompute tile windows for an edge array (numpy, pipeline side).

    nei: [M, K] int32, M divisible by `tile`. Returns a WindowedEdges of
    CPU tensors. `window` defaults to 4*tile; a tile whose unique-neighbour
    count exceeds it raises WindowOverflow (strict) or returns None. The
    shape rules are pcf_tpu's, so both packages window the same batches.
    """
    M, K = nei.shape
    window = 4 * tile if window is None else window
    if M % tile != 0 or (tile * K) % 128 != 0 or window % 128 != 0:
        if strict:
            raise WindowOverflow(
                f"windowed gather needs M ({M}) divisible by tile ({tile}), "
                f"tile*K ({tile * K}) and window ({window}) divisible by 128")
        return None
    T = M // tile
    tiles = nei.reshape(T, tile * K)
    window_rows = np.zeros((T, window), np.int32)
    local = np.zeros((T, tile * K), np.int32)
    for t in range(T):
        uniq, inv = np.unique(tiles[t], return_inverse=True)
        if uniq.size > window:
            if strict:
                raise WindowOverflow(
                    f"tile {t}: {uniq.size} unique neighbor rows exceed the "
                    f"window size {window}; raise cfg.window_size or check "
                    f"that the pipeline Morton-sorts each level")
            return None
        window_rows[t, : uniq.size] = uniq
        local[t] = inv

    return WindowedEdges(
        nei=torch.from_numpy(np.ascontiguousarray(nei, dtype=np.int32)),
        window_rows=torch.from_numpy(window_rows),
        localT=torch.from_numpy(np.ascontiguousarray(local[:, None, :])),
    )


# --------------------------------------------------------------------------
# Device op
# --------------------------------------------------------------------------

def windowed_take(table: torch.Tensor, edges: WindowedEdges) -> torch.Tensor:
    """table[edges.nei] via the tile windows: [N, C] -> [M, K, C];
    differentiable in `table`."""
    M, K = edges.nei.shape
    out = window_resolve(table.contiguous(), edges.window_rows, edges.localT)
    return out.reshape(M, K, table.shape[-1])


def windowed_take_flat(table: torch.Tensor, edges: WindowedEdges) -> torch.Tensor:
    """table[edges.nei] in k-major flat layout: [N, C] -> [M, K*C], with
    out[m, k*C + c] == table[nei[m, k], c]; no gradient (geometry is data)."""
    return window_resolve_flat(table.contiguous(), edges.window_rows, edges.localT,
                               edges.nei.shape[1])
