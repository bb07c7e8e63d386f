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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pcf_torch.ops.kernels import build
from pcf_torch.ops.kernels.window_scatter import window_scatter

_DTYPES = (torch.float32, torch.bfloat16)


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
    lib.window_resolve.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, i, i, i, p]
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
    row_bytes = C * table.element_size()
    chunk = next(c for c in (16, 8, 4, 2)
                 if row_bytes % c == 0 and table.data_ptr() % c == 0
                 and out.data_ptr() % c == 0)
    err = _lib().window_resolve(
        table.data_ptr(), window_rows.data_ptr(), localT.data_ptr(),
        out.data_ptr(), T * MtK, MtK, Wsz, N, row_bytes, chunk,
        torch.cuda.current_stream(table.device).cuda_stream)
    if err:
        raise RuntimeError(f"window_resolve launch failed with CUDA error {err}")
    window_resolve.launches += 1
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
        return _launch(table, window_rows, localT)

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
