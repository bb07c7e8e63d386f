"""Kernel A, the window resolve: out[t, e, :] = table[window_rows[t, localT[t, 0, e]], :].

Replaces pcf_tpu/ops/window.py::_fwd_kernel (via _resolve and
_windowed_take, impl "pallas"). The CUDA source, csrc/window_resolve.cu,
says why the H100 needs no one-hot product for it, what bounds it (bytes)
and how its threads copy rows.

`window_resolve` is differentiable in the table, as pcf_tpu's custom VJP
_windowed_take is: its forward is kernel A and its backward kernel D
(ops/kernels/window_scatter.py), which drops the gradient of out-of-range
window rows as pcf_tpu's scatter-add (mode="drop") does. Each takes its plain
version for CPU tensors and launches its kernel for CUDA tensors, or raises;
there is no fallback between the two. The backward runs only when the table
needs a gradient: geometry tables need none.

`window_resolve_flat` replaces pcf_tpu/ops/window.py::_fwd_kernel_flat (via
windowed_take_flat), the same selection emitted k-major flat,
out[m, k*C + c] = table[nei[m, k], c]. The TPU needed a kernel of its own
for it only because Mosaic cannot fold sublanes into lanes in VMEM; on the
H100 the row-major [T, Mt*K, C] output of kernel A is, byte for byte, the
flat [M, K*C] array, so it launches kernel A and returns a view, counting
its launches apart from A's. Like pcf_tpu's, it has no gradient: its output
is detached, as the stop_gradient at pcf_tpu's call site makes it.

`launch_plan` is the kernel's launch plan, computed on the host from shapes
alone (route, lanes per edge, edges per block, grid and shared memory), so
that it can be read and tested without a card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pcf_torch.ops.kernels import build
from pcf_torch.ops.kernels.window_scatter import window_scatter

_DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256
# a block's rows in shared memory stay within 16 KiB
MAX_EDGES_PER_BLOCK = 4096
# the fewest edges a block takes when a small level's tiles are split
MIN_EDGES_PER_BLOCK = 64
# two blocks for each of the H100's 132 SMs: a tile is split over blocks
# only until the grid reaches this
TARGET_BLOCKS = 2 * 132


def launch_plan(T: int, MtK: int, row_bytes: int, align: int) -> dict:
    """Kernel A's launch for T tiles of MtK edges of `row_bytes`-byte rows
    from a table whose address is a multiple of `align` (16 at most).

    unit: the largest of 16, 8, 4 and 2 bytes dividing both. Route "wide"
    (unit 16): `lanes` threads per edge, each copying every lanes-th
    16-byte vector of the row (at most 32 lanes, balanced over the passes a
    row wider than 32 vectors takes); "narrow" otherwise: 16-byte chunks of
    the output, each gathered unit by unit. The grid is (T, blocks a tile);
    edges_per_block is a multiple of 16, so every block's output starts
    16-byte aligned when MtK is a multiple of 16; smem holds the block's
    rows, 4 bytes an edge."""
    unit = next(u for u in (16, 8, 4, 2, 1) if row_bytes % u == 0 and align % u == 0)
    if unit == 1:
        raise ValueError(f"window_resolve: rows of {row_bytes} bytes at alignment "
                         f"{align} are not whole 2-byte units")
    route, lanes = "narrow", 0
    if unit == 16:
        chunks = row_bytes // 16
        passes = max(1, -(-chunks // 32))
        route, lanes = "wide", max(1, -(-chunks // passes))
    splits = max(-(-MtK // MAX_EDGES_PER_BLOCK),
                 min(-(-TARGET_BLOCKS // max(T, 1)), -(-MtK // MIN_EDGES_PER_BLOCK)), 1)
    epb = -(-MtK // splits)
    epb = max(16, -(-epb // 16) * 16)
    splits = max(1, -(-MtK // epb))
    if epb * row_bytes >= 2 ** 31 or splits > 65535:
        raise ValueError(f"window_resolve: {MtK} edges a tile of {row_bytes}-byte rows "
                         f"exceed the kernel's 32-bit in-tile offsets")
    return dict(route=route, unit=unit, lanes=lanes, edges_per_block=epb,
                grid=(T, splits), threads=THREADS, smem=epb * 4)


def plan_for(table: torch.Tensor, window_rows: torch.Tensor, localT: torch.Tensor) -> dict:
    """launch_plan of one call: its tiles, edges a tile, row bytes and the
    table's alignment (the largest power of two up to 16 dividing its
    address)."""
    ptr = table.data_ptr()
    return launch_plan(window_rows.shape[0], localT.shape[-1],
                       table.shape[1] * table.element_size(),
                       16 if ptr % 16 == 0 else ptr & -ptr)


def window_resolve_plain(table: torch.Tensor, window_rows: torch.Tensor,
                         localT: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [N, C] table -> [T, Mt*K, C], indices clamped
    to the table like jnp.take(mode="clip")."""
    T, Wsz = window_rows.shape
    slots = localT.reshape(T, -1).long().clamp(0, Wsz - 1)
    rows = torch.gather(window_rows.long(), 1, slots).clamp(0, table.shape[0] - 1)
    return table[rows.reshape(-1)].reshape(T, slots.shape[1], table.shape[1])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("window_resolve")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.window_resolve.argtypes = [p, p, p, p] + [i] * 10 + [p]
    lib.window_resolve.restype = i
    return lib


def _check(table, window_rows, localT):
    if table.device.type != "cuda":
        raise ValueError(f"window_resolve takes CPU or CUDA tensors, got {table.device}")
    if any(t.device != table.device for t in (window_rows, localT)):
        raise ValueError("window_resolve: all inputs must be on one device")
    if table.dtype not in _DTYPES or table.dim() != 2:
        raise ValueError(f"window_resolve: table must be a 2-D float32 or "
                         f"bfloat16 tensor, got {table.dtype} {tuple(table.shape)}")
    if window_rows.dtype != torch.int32 or localT.dtype != torch.int32:
        raise ValueError("window_resolve: window_rows and localT must be int32")
    if window_rows.dim() != 2 or localT.dim() != 3 or localT.shape[:2] != (
            window_rows.shape[0], 1):
        raise ValueError(f"window_resolve: window_rows [T, Wsz] and localT "
                         f"[T, 1, MtK] expected, got {tuple(window_rows.shape)} "
                         f"and {tuple(localT.shape)}")
    if not (table.is_contiguous() and window_rows.is_contiguous()
            and localT.is_contiguous()):
        raise ValueError("window_resolve: inputs must be contiguous")
    if table.shape[0] == 0:
        raise ValueError("window_resolve: empty table")


def _launch(table, window_rows, localT):
    _check(table, window_rows, localT)
    T, Wsz = window_rows.shape
    MtK = localT.shape[-1]
    N, C = table.shape
    out = torch.empty((T, MtK, C), dtype=table.dtype, device=table.device)
    plan = plan_for(table, window_rows, localT)
    err = _lib().window_resolve(
        table.data_ptr(), window_rows.data_ptr(), localT.data_ptr(), out.data_ptr(),
        T, MtK, Wsz, N, C * table.element_size(), plan["route"] == "wide", plan["unit"],
        plan["lanes"], plan["edges_per_block"], plan["grid"][1],
        torch.cuda.current_stream(table.device).cuda_stream)
    if err:
        raise RuntimeError(f"window_resolve launch failed with CUDA error {err}")
    return out


class WindowResolve(torch.autograd.Function):
    """Forward: kernel A (its plain version on the CPU). Backward: kernel D
    (its plain version on the CPU), when the table needs a gradient."""

    @staticmethod
    def forward(ctx, table, window_rows, localT):
        ctx.save_for_backward(window_rows, localT)
        ctx.table_rows, ctx.table_dtype = table.shape[0], table.dtype
        if table.device.type == "cpu":
            return window_resolve_plain(table, window_rows, localT)
        out = _launch(table, window_rows, localT)
        window_resolve.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        window_rows, localT = ctx.saved_tensors
        return (window_scatter(g.contiguous(), window_rows, localT, ctx.table_rows,
                               ctx.table_dtype), None, None)


def window_resolve(table: torch.Tensor, window_rows: torch.Tensor,
                   localT: torch.Tensor) -> torch.Tensor:
    """[N, C] table, [T, Wsz] window rows, [T, 1, Mt*K] slots -> [T, Mt*K, C]."""
    return WindowResolve.apply(table, window_rows, localT)


window_resolve.launches = 0


def windowed_take_flat_plain(table: torch.Tensor, window_rows: torch.Tensor,
                             localT: torch.Tensor, K: int) -> torch.Tensor:
    """Plain PyTorch version of the flat resolve: [N, C] -> [M, K*C]."""
    out = window_resolve_plain(table, window_rows, localT)
    return out.reshape(-1, K * table.shape[1])


def window_resolve_flat(table: torch.Tensor, window_rows: torch.Tensor,
                        localT: torch.Tensor, K: int) -> torch.Tensor:
    """[N, C] table, [T, Wsz] window rows, [T, 1, Mt*K] slots -> [M, K*C],
    k-major flat, with no gradient."""
    table = table.detach()
    if table.device.type == "cpu":
        return windowed_take_flat_plain(table, window_rows, localT, K)
    if localT.shape[-1] % K:
        raise ValueError(f"window_resolve_flat: Mt*K={localT.shape[-1]} is not a "
                         f"multiple of K={K}")
    out = _launch(table, window_rows, localT)
    window_resolve_flat.launches += 1
    return out.reshape(-1, K * table.shape[1])


window_resolve_flat.launches = 0
