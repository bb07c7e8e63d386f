"""Kernel D, the window scatter: the backward of the window resolve.

    dtable[r, :] = sum of g[t, e, :] over the edges whose window row
                   window_rows[t, localT[t, 0, e]] is r,  for 0 <= r < N

Rows outside [0, N) are dropped, as pcf_tpu's scatter-add (mode="drop")
drops them, although the forward clamps them. The sum runs in f32 and is
cast once to the table's dtype. Replaces pcf_tpu/ops/window.py::_bwd_kernel
(via _scatter_to_windows) and the scatter-add into the table after it
(_windowed_take_bwd). The CUDA source, csrc/window_scatter.cu, says how a
call inverts the edge -> row map and sums each row without atomics on the
table, and what bounds it.

`window_scatter` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, or raises; there is no fallback between the two.
The kernel's bucket order comes from integer atomics, so its f32 sums may
differ in the last bits from run to run.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pcf_torch.ops.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)


def window_scatter_plain(g: torch.Tensor, window_rows: torch.Tensor,
                         localT: torch.Tensor, n_rows: int,
                         dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version: per-slot f32 sums (f64 for an f64 g), then the
    in-range slots summed into their table rows, then the cast.
    g [T, Mt*K, C] -> [N, C]."""
    T, Wsz = window_rows.shape
    C = g.shape[-1]
    slots = localT.reshape(T, -1).long().clamp(0, Wsz - 1)
    slots = slots + torch.arange(T, device=g.device)[:, None] * Wsz
    acc = torch.promote_types(g.dtype, torch.float32)
    dwin = torch.zeros(T * Wsz, C, dtype=acc, device=g.device)
    dwin.index_add_(0, slots.reshape(-1), g.reshape(-1, C).to(acc))
    rows = window_rows.reshape(-1).long()
    keep = (rows >= 0) & (rows < n_rows)
    dtable = torch.zeros(n_rows, C, dtype=acc, device=g.device)
    dtable.index_add_(0, rows[keep], dwin[keep])
    return dtable.to(dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("window_scatter")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.window_scatter.argtypes = [i, i, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.window_scatter.restype = i
    lib.window_scatter_workspace.argtypes = [i, ctypes.c_longlong, i]
    lib.window_scatter_workspace.restype = ctypes.c_longlong
    lib.window_scatter_cap.argtypes = [i, ctypes.c_longlong]
    lib.window_scatter_cap.restype = i
    return lib


def bucket_cap(n_rows: int, edges: int) -> int:
    """Edges the kernel keeps in a row's bucket for these sizes; the rest of
    a row's edges go through its overflow pass (builds the library)."""
    return _lib().window_scatter_cap(n_rows, edges)


def _check(g, window_rows, localT, dtype):
    if g.device.type != "cuda":
        raise ValueError(f"window_scatter takes CPU or CUDA tensors, got {g.device}")
    if any(t.device != g.device for t in (window_rows, localT)):
        raise ValueError("window_scatter: all inputs must be on one device")
    if g.dtype not in _DTYPES or dtype not in _DTYPES or g.dim() != 3:
        raise ValueError(f"window_scatter: g must be a 3-D float32 or bfloat16 tensor "
                         f"and the table float32 or bfloat16, got {g.dtype} "
                         f"{tuple(g.shape)} and {dtype}")
    if window_rows.dtype != torch.int32 or localT.dtype != torch.int32:
        raise ValueError("window_scatter: window_rows and localT must be int32")
    T = window_rows.shape[0]
    if window_rows.dim() != 2 or localT.shape != (T, 1, g.shape[1]) \
            or g.shape[0] != T:
        raise ValueError(f"window_scatter: g [T, MtK, C], window_rows [T, Wsz] and "
                         f"localT [T, 1, MtK] expected, got {tuple(g.shape)}, "
                         f"{tuple(window_rows.shape)} and {tuple(localT.shape)}")
    if not (g.is_contiguous() and window_rows.is_contiguous()
            and localT.is_contiguous()):
        raise ValueError("window_scatter: inputs must be contiguous")


def _run(g, window_rows, localT, n_rows, dtype, inverse_only=False):
    """Check the operands, launch the kernel's passes, return the table (not
    written when `inverse_only`)."""
    _check(g, window_rows, localT, dtype)
    T, MtK, C = g.shape
    Wsz = window_rows.shape[1]
    out = torch.empty((n_rows, C), dtype=dtype, device=g.device)
    ws = torch.empty(_lib().window_scatter_workspace(n_rows, T * MtK, C),
                     dtype=torch.uint8, device=g.device)
    esz = g.element_size()
    chunk = next(c for c in (16, 8, 4, 2)
                 if c >= esz and (C * esz) % c == 0 and g.data_ptr() % c == 0)
    err = _lib().window_scatter(
        int(g.dtype == torch.bfloat16), int(dtype == torch.bfloat16), g.data_ptr(),
        window_rows.data_ptr(), localT.data_ptr(), out.data_ptr(), ws.data_ptr(), T, MtK,
        Wsz, n_rows, C, chunk, int(inverse_only),
        torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f"window_scatter launch failed with CUDA error {err}")
    return out


def window_scatter(g: torch.Tensor, window_rows: torch.Tensor, localT: torch.Tensor,
                   n_rows: int, dtype: torch.dtype) -> torch.Tensor:
    """g [T, Mt*K, C] cotangents, [T, Wsz] window rows, [T, 1, Mt*K] slots
    -> the gradient of an [n_rows, C] table of `dtype`."""
    if g.device.type == "cpu":
        return window_scatter_plain(g, window_rows, localT, n_rows, dtype)
    out = _run(g, window_rows, localT, n_rows, dtype)
    window_scatter.launches += 1
    return out


def window_scatter_inverse(g, window_rows, localT, n_rows, dtype) -> None:
    """Only the first pass of a window_scatter call on the card, which
    inverts the edge -> row map (for timing it apart from the reduction);
    not counted in window_scatter.launches."""
    _run(g, window_rows, localT, n_rows, dtype, inverse_only=True)


window_scatter.launches = 0
