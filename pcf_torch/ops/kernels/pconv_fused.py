"""Kernels B and C, the fused neighbourhood conv + output linear.

  B  pcf_conv_linear       out = b + pconv(gather(feats) * guidance[.., c % H], v) @ L
  C  pconv_pe_conv_linear  out = b + pconv(gather(feats) ++ add, v) @ L

with pconv(x, v)[m, c*W + w] = sum_k x[m,k,c] * v[m,k,w] (c-major). They
replace pcf_tpu/ops/pallas/pconv_kernel.py::_make_pcf_kernel and
::_pconv_kernel (plain edges, via _run_fused) and ::_make_windowed_kernel
(WindowedEdges, via _run_fused_windowed), each in its guided and PE forms.
Both are one CUDA source, csrc/pcf_conv_linear.cu (C is a template mode of
B's kernel: 64-point tiles, L staged by cp.async, the bf16 projection on the
tensor cores), which says what bounds them and how a block keeps the
[M, Ct*W] contraction output out of device memory.

Each wrapper takes the plain version for CPU tensors and launches its kernel
for CUDA tensors, or raises; there is no fallback. `edges` is either the
[M, K] int32 index array or a WindowedEdges, whose rows the kernel resolves
itself. Both are differentiable: the backward is pcf_tpu's, the autograd of
the same composition recomputed on the saved inputs (_FusedConvLinear).

Numerics (both versions): the K-reduction in f32; when feats, the
guidance/PE rows and v are all bf16, the [M, Ct*W] partials and L are rounded
to bf16 before the projection, which accumulates in f32 (pcf_tpu's
_contract_and_project). Operands of mixed dtypes all run in f32. Output f32
[M, O]. The plain versions also take f64 operands and then run in f64 (a
reference for rounding studies; the kernels take f32 and bf16 only).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pcf_torch.ops.kernels import build
from pcf_torch.ops.gather import take_rows
from pcf_torch.ops.kernels.derived import cached
from pcf_torch.ops.kernels.window_resolve import window_resolve, window_resolve_plain
from pcf_torch.ops.window import WindowedEdges

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_W = 16  # the kernels' register tile of W partial sums


def _gather_plain(feats, edges) -> torch.Tensor:
    """[N, C] -> [M, K, C] in either index mode, clamped like mode="clip"."""
    if isinstance(edges, WindowedEdges):
        M, K = edges.nei.shape
        return window_resolve_plain(feats, edges.window_rows,
                                    edges.localT).reshape(M, K, -1)
    return take_rows(feats, edges.long().clamp(0, feats.shape[0] - 1))


def _gather_grad(feats, edges) -> torch.Tensor:
    """The backward's gather, differentiable in feats: WindowedEdges through
    the window resolve (kernels A and D on the card, as pcf_tpu's VJP runs
    _resolve and _scatter_to_windows), plain edges by clamped indexing."""
    if isinstance(edges, WindowedEdges):
        M, K = edges.nei.shape
        return window_resolve(feats, edges.window_rows,
                              edges.localT).reshape(M, K, -1)
    return take_rows(feats, edges.long().clamp(0, feats.shape[0] - 1))


def _common_dtype(*operands):
    """The kernels' multiplicand type: bf16 iff every operand is bf16
    (pcf_tpu's compute_dtype contract), else f32 for all (f64 if any is)."""
    if all(t.dtype == torch.bfloat16 for t in operands):
        return operands
    dt = functools.reduce(torch.promote_types, (t.dtype for t in operands), torch.float32)
    return tuple(t.to(dt) for t in operands)


def _project_plain(x, weights, linear_w, linear_b, bf16: bool):
    M = x.shape[0]
    s = torch.einsum("mkc,mkw->mcw", x, weights.to(x.dtype)).reshape(M, -1)
    lw = linear_w.to(x.dtype)
    if bf16:
        s, lw = s.bfloat16().float(), lw.bfloat16().float()
    return torch.addmm(linear_b.to(x.dtype), s, lw)


def _compose(gather, guided, feats, edges, extra, weights, linear_w, linear_b):
    """Kernel B (guided) or C as a composition of PyTorch operations: the
    gather, then the guidance modulation or the PE concatenation, then the
    K-contraction and the projection, with the kernels' bf16 rounding."""
    if extra is None:
        extra = weights.new_empty(weights.shape[:2] + (0,))
    feats, extra, weights = _common_dtype(feats, extra, weights)
    acc = torch.promote_types(feats.dtype, torch.float32)
    x = gather(feats, edges).to(acc)
    if guided:
        M, K, C = x.shape
        H = extra.shape[-1]
        x = (x.reshape(M, K, C // H, H) * extra.to(acc)[:, :, None, :]).reshape(M, K, C)
    else:
        x = torch.cat([x, extra.to(acc)], dim=-1)
    return _project_plain(x, weights, linear_w, linear_b,
                          feats.dtype == torch.bfloat16)


def pcf_conv_linear_plain(feats, edges, guidance, weights, linear_w, linear_b):
    """Plain PyTorch version of kernel B."""
    return _compose(_gather_plain, True, feats, edges, guidance, weights,
                    linear_w, linear_b)


def pconv_pe_conv_linear_plain(feats, edges, add, weights, linear_w, linear_b):
    """Plain PyTorch version of kernel C; `add` [M, K, P] may be None."""
    return _compose(_gather_plain, False, feats, edges, add, weights,
                    linear_w, linear_b)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The library of kernels B and C."""
    ll, p, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    lib = build.load("pcf_conv_linear")
    lib.pcf_conv_linear_shape.argtypes = [i, i, i, i, i, i, ctypes.POINTER(ll)]
    lib.pcf_conv_linear_shape.restype = None
    for fn in (lib.pcf_conv_linear, lib.pconv_pe_conv_linear):
        fn.argtypes = [i, p, i, i, p, p, p, i, i, p, i, p, i, p, p, i, p, i, i, p]
        fn.restype = i
    return lib


def launch_shape(C: int, K: int, W: int, O: int, M: int, bf16: bool, P: int = 0) -> dict:
    """The launch shape of kernel B (P = 0) or C (PE width P) for these
    sizes: points per block, O slices and columns per slice, channel-chunk
    ranges (blocks that add their partial outputs), blocks, dynamic shared
    memory bytes, threads per block, and where the contraction and the
    projection run."""
    out = (ctypes.c_longlong * 8)()
    _lib().pcf_conv_linear_shape(int(bf16), C + P, K, W, O, M, out)
    return dict(points=out[0], o_slices=out[1], o_per_slice=out[2], c_splits=out[3],
                blocks=out[4], smem=out[5], threads=out[6], contraction="CUDA cores f32",
                projection="mma.sync m16n8k16 bf16" if out[7] else "CUDA cores f32")


def _bf16_weight(lw: torch.Tensor, keep: bool) -> torch.Tensor:
    """The bf16 projection operand of kernels B and C: L rounded to bf16 (as
    the plain version rounds it), columns zero-padded to a multiple of 8.
    With `keep` (inference) it is kept on the tensor (derived.cached: until
    L's address or _version changes). A forward that builds a gradient
    rounds afresh: in a captured train step L changes at every replay, so
    the rounding must be part of the graph."""
    def rounded():
        CW, O = lw.shape
        OP = -(-O // 8) * 8
        if OP == O:
            return lw.to(torch.bfloat16, copy=True)
        copy = lw.new_zeros((CW, OP), dtype=torch.bfloat16)
        copy[:, :O] = lw
        return copy

    if not keep:
        with torch.no_grad():
            return rounded()
    return cached(lw.__dict__, "_pcf_bf16", (lw,), rounded)


def _launch(name, feats, edges, extra, weights, linear_w, linear_b, keep_weight=True):
    """Check the operands of kernel B or C, launch it, return its output.
    `keep_weight`: the bf16 L may be kept between calls (_bf16_weight)."""
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {dev}")
    idx = ((edges.nei, edges.window_rows, edges.localT)
           if isinstance(edges, WindowedEdges) else (edges,))
    tensors = (feats, extra, weights, linear_w, linear_b) + idx
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if feats.dtype not in _DTYPES or extra.dtype != feats.dtype \
            or weights.dtype != feats.dtype:
        raise ValueError(f"{name}: feats, {'guidance' if name == 'pcf_conv_linear' else 'add'} "
                         f"and weights must share one dtype, float32 or bfloat16; got "
                         f"{feats.dtype}, {extra.dtype}, {weights.dtype}")
    if linear_w.dtype != torch.float32 or linear_b.dtype != torch.float32:
        raise ValueError(f"{name}: linear_w and linear_b must be float32")
    if any(t.dtype != torch.int32 for t in idx):
        raise ValueError(f"{name}: edge indices must be int32")
    N, C = feats.shape
    M, K, W = weights.shape
    E = extra.shape[-1]
    Ct = C if name == "pcf_conv_linear" else C + E
    O = linear_w.shape[-1]
    if edges.shape != (M, K) or extra.shape[:2] != (M, K) \
            or linear_w.shape != (Ct * W, O) or linear_b.shape != (O,):
        raise ValueError(f"{name}: shapes do not agree: feats {tuple(feats.shape)}, "
                         f"edges {tuple(edges.shape)}, extra {tuple(extra.shape)}, "
                         f"weights {tuple(weights.shape)}, linear_w "
                         f"{tuple(linear_w.shape)}, linear_b {tuple(linear_b.shape)}")
    if W > _MAX_W:
        raise ValueError(f"{name}: W={W} exceeds the kernel's {_MAX_W}")
    if name == "pcf_conv_linear" and C % E:
        raise ValueError(f"{name}: channels {C} not divisible by heads {E}")
    if feats.dtype == torch.bfloat16:
        linear_w = _bf16_weight(linear_w, keep_weight)
    if isinstance(edges, WindowedEdges):
        T, Wsz = edges.window_rows.shape
        MtK = edges.localT.shape[-1]
        if edges.localT.shape != (T, 1, MtK) or MtK % K or T * (MtK // K) != M:
            raise ValueError(f"{name}: window arrays {tuple(edges.window_rows.shape)}, "
                             f"{tuple(edges.localT.shape)} do not tile M={M}, K={K}")
        nei, wr, lt = None, edges.window_rows.data_ptr(), edges.localT.data_ptr()
    else:
        Wsz = MtK = 0
        nei, wr, lt = edges.data_ptr(), None, None
    out = torch.empty((M, O), dtype=torch.float32, device=dev)
    err = getattr(_lib(), name)(
        int(feats.dtype == torch.bfloat16), feats.data_ptr(), N, C, nei, wr, lt,
        Wsz, MtK, extra.data_ptr(), E, weights.data_ptr(), W,
        linear_w.data_ptr(), linear_b.data_ptr(), O, out.data_ptr(), M, K,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    return out


class _FusedConvLinear(torch.autograd.Function):
    """Forward: kernel B (guided) or C, or its plain version on the CPU.
    Backward: pcf_tpu's VJP of the fused kernels (pconv_kernel.py:224-235,
    :481-491), the autograd of the composition the kernel computes,
    recomputed on the saved inputs. Its window-mode gather goes through the
    window resolve, so on the card the backward launches kernels A and D."""

    @staticmethod
    def forward(ctx, guided, training, feats, edges, extra, weights, linear_w, linear_b):
        ctx.guided, ctx.edges = guided, edges
        ctx.save_for_backward(feats, extra, weights, linear_w, linear_b)
        if feats.device.type == "cpu":
            return _compose(_gather_plain, guided, feats, edges, extra, weights,
                            linear_w, linear_b)
        if extra is None:
            extra = weights.new_empty(weights.shape[:2] + (0,))
        feats, extra, weights = _common_dtype(feats, extra, weights)
        wrapper = pcf_conv_linear if guided else pconv_pe_conv_linear
        out = _launch(wrapper.__name__, feats, edges, extra, weights, linear_w, linear_b,
                      keep_weight=not training)
        wrapper.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        needs = (ctx.needs_input_grad[2],) + ctx.needs_input_grad[4:]
        with torch.enable_grad():
            ins = [t if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, needs)]
            out = _compose(_gather_grad, ctx.guided, ins[0], ctx.edges, *ins[1:])
            wrt = [t for t in ins if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g))
        d = [next(grads) if t is not None and t.requires_grad else None for t in ins]
        return None, None, d[0], None, *d[1:]


def _training(linear_w) -> bool:
    """Whether the call builds a gradient of L (decided outside the
    autograd Function, whose forward runs without grad)."""
    return torch.is_grad_enabled() and linear_w.requires_grad


def pcf_conv_linear(feats, edges, guidance, weights, linear_w, linear_b):
    """Kernel B: feats [N, C], edges [M, K] or WindowedEdges, guidance
    [M, K, H], weights [M, K, W], linear_w [C*W, O], linear_b [O] -> f32 [M, O]."""
    return _FusedConvLinear.apply(True, _training(linear_w), feats, edges, guidance,
                                  weights, linear_w, linear_b)


def pconv_pe_conv_linear(feats, edges, add, weights, linear_w, linear_b):
    """Kernel C: as kernel B with PE features add [M, K, P] (P >= 0, or None)
    appended to the gathered rows; linear_w is [(C+P)*W, O]."""
    return _FusedConvLinear.apply(False, _training(linear_w), feats, edges, add,
                                  weights, linear_w, linear_b)


pcf_conv_linear.launches = 0
pconv_pe_conv_linear.launches = 0
