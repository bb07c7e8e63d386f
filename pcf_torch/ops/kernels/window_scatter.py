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
The kernel is deterministic: it sorts the edges by row, stably, and sums
every row in a fixed order, so two launches on the same inputs give the same
bits. Its two workspaces, the inverse of the edge -> row map and the
reduction's, are laid out here (`workspace_layout`) and checked by the
kernel. Inside `shared_inverses()` (the train step's backward) calls on one
edge set share one inverse: every layer of a level scatters through the same
window rows and slots.
"""

from __future__ import annotations

import ctypes
import functools
from contextlib import contextmanager

import torch

from pcf_torch.ops.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
_TILE = 2048            # edges per tile of the radix sort (256 threads x 8)
_RADIX = 256            # 8 bits a sort pass
_MIN_CAP, _MAX_CAP = 32, 256


def _up16(b: int) -> int:
    return -(-b // 16) * 16


def piece_len(n_rows: int, edges: int) -> int:
    """Positions of the kernel's pieces for these sizes: 4x the mean fan-in
    as a power of two, 32 to 256. A row with more edges is heavy: the kernel
    sums it piece by piece."""
    fan_in = edges // n_rows if n_rows > 0 else 0
    cap = _MIN_CAP
    while cap < _MAX_CAP and cap < 4 * fan_in:
        cap *= 2
    return cap


def workspace_layout(n_rows: int, edges: int, C: int) -> dict:
    """The kernel's workspaces for these sizes (csrc/window_scatter.cu's
    Layout): the radix sort's passes (8 bits each, keys 0..n_rows), tiles and
    pieces, and the byte offset of each 16-byte aligned section. The
    inverse: keys and edge ids twice [edges] int32, histograms [256, tiles]
    and digit totals [256] int32, row offsets [n_rows + 1] int32,
    `inverse_bytes` in all. The reduction: the pieces' head and tail slots
    [pieces, C] f32, `reduce_bytes` in all."""
    cap = piece_len(n_rows, edges)
    bits = 1
    while bits < 31 and (1 << bits) <= n_rows:
        bits += 1
    out = dict(cap=cap, tiles=-(-edges // _TILE), passes=-(-bits // 8),
               pieces=-(-edges // cap))
    for sections, total in (((("key0", 4 * edges), ("val0", 4 * edges), ("key1", 4 * edges),
                              ("val1", 4 * edges), ("hist", 4 * _RADIX * out["tiles"]),
                              ("total", 4 * _RADIX), ("offsets", 4 * (n_rows + 1))),
                             "inverse_bytes"),
                            ((("head", 4 * out["pieces"] * C),
                              ("tail", 4 * out["pieces"] * C)), "reduce_bytes")):
        at = 0
        for name, size in sections:
            out[name] = at
            at = _up16(at + size)
        out[total] = at
    return out


_SHARED: dict | None = None  # the inverses of shared_inverses(), by edge set


@contextmanager
def shared_inverses():
    """Inside, window_scatter inverts each edge set (window rows, slots and
    table rows) once and reuses that inverse for its later calls, in any
    thread (autograd runs a backward in its own). The edge arrays must not
    change inside; the train step wraps its backward in it. The result is
    the same, bit for bit: the inverse reads nothing else."""
    global _SHARED
    outer, _SHARED = _SHARED, {}
    try:
        yield
    finally:
        _SHARED = outer


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
    ll = ctypes.c_longlong
    lib.window_scatter.argtypes = [i, i, p, p, p, p, p, ll, i, p, ll, i, i, i, i, i, i, i, p]
    lib.window_scatter.restype = i
    lib.window_scatter_inverse_bytes.argtypes = [i, ll]
    lib.window_scatter_inverse_bytes.restype = ll
    lib.window_scatter_reduce_bytes.argtypes = [i, ll, i]
    lib.window_scatter_reduce_bytes.restype = ll
    lib.window_scatter_cap.argtypes = [i, ctypes.c_longlong]
    lib.window_scatter_cap.restype = i
    return lib


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
    lay = workspace_layout(n_rows, T * MtK, C)
    key = (window_rows.data_ptr(), localT.data_ptr(), tuple(window_rows.shape),
           tuple(localT.shape), n_rows)
    shared = None if _SHARED is None or inverse_only else _SHARED.get(key)
    if shared is None:
        inverse = torch.empty(lay["inverse_bytes"], dtype=torch.uint8, device=g.device)
        if _SHARED is not None and not inverse_only:
            # the edge arrays are kept with it: their addresses stay theirs
            _SHARED[key] = (window_rows, localT, inverse)
    else:
        inverse = shared[2]
    work = lay["reduce_bytes"]
    ws = torch.empty(work, dtype=torch.uint8, device=g.device)
    esz = g.element_size()
    chunk = next(c for c in (16, 8, 4, 2)
                 if c >= esz and (C * esz) % c == 0 and g.data_ptr() % c == 0)
    err = _lib().window_scatter(
        int(g.dtype == torch.bfloat16), int(dtype == torch.bfloat16), g.data_ptr(),
        window_rows.data_ptr(), localT.data_ptr(), out.data_ptr(), inverse.data_ptr(),
        lay["inverse_bytes"], int(shared is not None), ws.data_ptr(), work, T, MtK,
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
    """Only the inverse of a window_scatter call on the card (key, sort and
    row offsets: the edge -> row map inverted), for timing it apart from the
    reduction; not counted in window_scatter.launches."""
    _run(g, window_rows, localT, n_rows, dtype, inverse_only=True)


window_scatter.launches = 0
