"""Kernel E, the whole-layer inference kernel: one conv layer's middle in one
launch.

Replaces pcf_tpu/attic/eval_kernel.py::fused_layer_eval (its pallas_call)
and computes what that kernel computes, per output point m and neighbour k
(row = window_rows[t, localT[t, 0, e]], both indices clamped):

  geometry   loc = xyz[row] - centre[m]; VI (12-d) with USE_VI, else loc
  WeightNet  v = MLP(VI)                          folded Linear+BN, ReLU after each
  PE         pe = MLP(VI) (pe_on_vi), MLP(loc) (pe_convs), or VI (concat_wni)
  guidance   q = [guid[row] | pe]; key = q at k = 0, or max over K if strided;
             s = sigmoid(MLP(q - key)) [H]; x[c] = feats[row, c] * s[c % H]
  otherwise  x = [feats[row, :Cx] | pe]
  contract   S[m, c*W + w] = sum_k x[m, k, c] * v[m, k, w]
  project    out[m] = ReLU(S[m] @ L + b)         L [Ct*W, O], c-major rows
  shortcut   short[m] = max_k feats[row, Cx+Cg:]  when strided

Both outputs take the feature table's dtype.

Every BatchNorm is folded into its Linear before the call
(nn/fused_eval.py), so the kernel sees plain (w [ci, co], b [co]) pairs.
The feature table is [N, Cx+Cg+Cs] in the order conv | guidance | shortcut
and the geometry table [N, 3] or [N, 6] (xyz | normals) f32, as pcf_tpu's.
The CUDA source, csrc/layer_eval.cu, says what bounds it and how a block
keeps every per-edge intermediate out of device memory. The kernel takes the
folded weights in its own form (packed_weights: the MLP pairs in one padded
f32 buffer, L in bf16 for a bf16 table), made once and kept on the linear
weight until one of the folded tensors changes (ops/kernels/derived.py).

Rounding (both versions): with an f32 feature table every product and sum
is f32. With a bf16 table everything between the reads and the projection
is f32, as in kernels B and C: the geometry, the MLPs (f32 weights and
activations), the guidance scores, the gathered features times the scores,
the contraction over K. The contraction's sum is rounded to bf16 and the
projection multiplies it by L rounded to bf16, into f32; the output is
rounded to bf16. pcf_tpu's kernel rounds four more things in its bf16 mode:
the MLPs' multiplicands and outputs, features times scores, and each
contraction product before the sum over K; on trained weights that left
the bf16 whole-layer forward up to 2.5 times as far from the f32 model as
the standard bf16 forward. pcf_tpu's bf16 mode also reads the geometry
through a hi/lo bf16 pair (about 2^-16 relative); both versions here read
the f32 geometry itself.

`fused_layer_eval` launches kernel E for CUDA tensors, or raises; it takes
`fused_layer_eval_plain` only for CPU tensors. Neither has a backward:
inference only, as pcf_tpu's. It runs through a torch custom operator,
`pcf::layer_eval` (layer_eval_op), whose fake gives the outputs' shapes, so
that torch.export traces a forward into a program that calls it
(serve/export.py); the packing of the weights and the kernel's launch
arguments, which read addresses, are made inside its real implementation.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pcf_torch.ops.kernels import build
from pcf_torch.ops.kernels.derived import cached
from pcf_torch.ops.kernels.window_resolve import window_resolve_plain
from pcf_torch.ops.vi_transform import VI_coordinate_transform
from pcf_torch.ops.window import WindowedEdges

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_LAYERS = 4  # MLP layers per branch in the kernel's descriptor
_MAX_W = 16      # the kernel's register tile of W partial sums
_MAX_K = 16      # neighbours whose v a kernel thread holds in registers


def _widths(wn, pe, gd, linear_w, *, Cx, use_vi, concat_wni):
    """(W, Cpe, Ct) of a call, from the folded weights' shapes."""
    W = wn[-1][0].shape[-1]
    Cpe = (12 if use_vi else 3) if concat_wni else (pe[-1][0].shape[-1] if pe else 0)
    Ct = Cx if gd else Cx + Cpe
    if linear_w.shape[0] != Ct * W:
        raise ValueError(f"fused_layer_eval: linear_w {tuple(linear_w.shape)} is not "
                         f"[Ct*W, O] with Ct={Ct}, W={W}")
    return W, Cpe, Ct


def _mlp_plain(x, pairs, final, acc):
    """Folded MLP in acc; ReLU between layers, `final` ("relu" or
    "sigmoid") after the last."""
    for i, (w, b) in enumerate(pairs):
        x = x.to(acc) @ w.to(acc) + b.to(acc)
        x = torch.sigmoid(x) if i == len(pairs) - 1 and final == "sigmoid" else x.relu()
    return x


def fused_layer_eval_plain(feat_table, geo_table, edges, center_xyz, center_norm,
                           wn, pe, gd, linear_w, linear_b, *, Cx: int, Cg: int = 0,
                           Cs: int = 0, use_vi: bool, pe_on_vi: bool = True,
                           concat_wni: bool = False, strided: bool = False,
                           num_heads: int = 0):
    """Plain PyTorch version of kernel E. Returns (out [M, O], shortcut
    [M, Cs] or None)."""
    M, K = edges.nei.shape
    W, Cpe, Ct = _widths(wn, pe, gd, linear_w, Cx=Cx, use_vi=use_vi, concat_wni=concat_wni)
    acc = torch.promote_types(feat_table.dtype, torch.float32)
    mm = torch.bfloat16 if feat_table.dtype == torch.bfloat16 else acc

    feats = window_resolve_plain(feat_table, edges.window_rows,
                                 edges.localT).reshape(M, K, -1)
    geo = window_resolve_plain(geo_table.to(acc), edges.window_rows,
                               edges.localT).reshape(M, K, -1)
    loc = geo[..., :3] - center_xyz.to(acc)[:, None, :]
    wni = (VI_coordinate_transform(loc, geo[..., 3:6], center_norm.to(acc))
           if use_vi else loc)
    wgt = _mlp_plain(wni, wn, "relu", acc)
    pe_v = None
    if pe:
        pe_in = wni if pe_on_vi else wni[..., 9:12] if use_vi else wni
        pe_v = _mlp_plain(pe_in, pe, "relu", acc)
    elif concat_wni:
        pe_v = wni

    gath = feats[..., :Cx].to(acc)
    if gd:
        q = torch.cat([feats[..., Cx:Cx + Cg].to(acc), pe_v], dim=-1)
        key = q.amax(dim=1, keepdim=True) if strided else q[:, :1]
        sc = _mlp_plain(q - key, gd, "sigmoid", acc)
        gath = gath * sc.repeat(1, 1, Cx // num_heads)  # channel c takes head c % H
    if Ct > Cx:
        gath = torch.cat([gath, pe_v], dim=-1)
    # summed over K in acc, one W column at a time; the sums and L in mm
    pc = torch.stack([(gath * wgt[..., w:w + 1]).sum(dim=1)
                      for w in range(W)], dim=-1).reshape(M, Ct * W)
    out = (pc.to(mm).to(acc) @ linear_w.to(mm).to(acc) + linear_b.to(acc)).relu()
    short = feats[..., Cx + Cg:Cx + Cg + Cs].amax(dim=1) if strided else None
    return out.to(feat_table.dtype), short


class _Mlp(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("din", ctypes.c_int * _MAX_LAYERS),
                ("dout", ctypes.c_int * _MAX_LAYERS), ("w", ctypes.c_int * _MAX_LAYERS),
                ("b", ctypes.c_int * _MAX_LAYERS)]


class _Args(ctypes.Structure):
    """csrc/layer_eval.cu's LayerEvalArgs, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "feats", "geo", "window_rows", "localT", "cxyz", "cnorm", "params", "L", "bias",
        "out", "shortcut")] + [(n, ctypes.c_int) for n in (
            "n_rows", "Cf", "Gd", "wsz", "mtk", "M", "K", "Cx", "Cg", "Cs", "W", "O",
            "H", "Cpe", "Ct", "lin", "use_vi", "pe_on_vi", "concat_wni", "strided",
            "bf16")] + [("wn", _Mlp), ("pe", _Mlp), ("gd", _Mlp)]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("layer_eval")
    lib.layer_eval.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p, ctypes.c_void_p]
    lib.layer_eval.restype = ctypes.c_int
    lib.layer_eval_shape.argtypes = [ctypes.POINTER(_Args), ctypes.POINTER(ctypes.c_longlong)]
    lib.layer_eval_shape.restype = None
    return lib


def padded_width(dout: int) -> int:
    """Columns of a packed MLP layer: dout rounded up to a power of two, at
    least 4 (csrc/layer_eval.cu's padded_width)."""
    return max(4, 1 << (dout - 1).bit_length())


class Packed(NamedTuple):
    """Kernel E's form of a layer's folded weights: every MLP pair in one f32
    buffer (w [din, dp] row-major, then b [dp], dp = padded_width(dout), the
    padding zero, each at an offset of a multiple of 4 floats), the three MLP
    descriptors, the projection's L (the f32 linear weight itself, or its
    bf16 copy with columns zero-padded to a multiple of 8) and bias."""
    params: torch.Tensor
    mlps: tuple
    L: torch.Tensor
    bias: torch.Tensor


def _pack(wn, pe, gd, linear_w, linear_b, bf16: bool) -> Packed:
    parts, off, mlps = [], 0, []
    for pairs in (wn, pe, gd):
        if len(pairs) > _MAX_LAYERS:
            raise ValueError(f"fused_layer_eval: {len(pairs)} MLP layers, the kernel "
                             f"takes {_MAX_LAYERS}")
        d = _Mlp(n=len(pairs))
        for i, (w, b) in enumerate(pairs):
            if w.dim() != 2 or b.shape != (w.shape[1],) or (
                    i and w.shape[0] != pairs[i - 1][0].shape[1]):
                raise ValueError(f"fused_layer_eval: MLP layer {i} shapes "
                                 f"{tuple(w.shape)}, {tuple(b.shape)} do not chain")
            din, dout = w.shape
            dp = padded_width(dout)
            wp = w.new_zeros((din, dp), dtype=torch.float32)
            wp[:, :dout] = w
            bp = b.new_zeros(dp, dtype=torch.float32)
            bp[:dout] = b
            d.din[i], d.dout[i] = din, dout
            d.w[i], d.b[i] = off, off + din * dp
            parts += [wp.reshape(-1), bp]
            off += (din + 1) * dp
        mlps.append(d)
    params = torch.cat(parts)
    if bf16:
        CW, O = linear_w.shape
        L = linear_w.new_zeros((CW, -(-O // 8) * 8), dtype=torch.bfloat16)
        L[:, :O] = linear_w
    else:
        L = linear_w.float().contiguous()
    return Packed(params, tuple(mlps), L, linear_b.float().contiguous())


def packed_weights(wn, pe, gd, linear_w, linear_b, bf16: bool) -> Packed:
    """_pack's result, kept on linear_w until any of these tensors changes
    (_version or data_ptr; derived.cached): the
    folds nn/fused_eval.py keeps per layer are the same tensors from call to
    call, so a steady-state call packs nothing."""
    tensors = (linear_w, linear_b) + tuple(t for pairs in (wn, pe, gd)
                                           for p in pairs for t in p)
    return cached(linear_w.__dict__.setdefault("_pcf_eval_pack", {}), bf16, tensors,
                  lambda: _pack(wn, pe, gd, linear_w, linear_b, bf16))


def _prepare(feat_table, geo_table, edges, center_xyz, center_norm, wn, pe, gd,
             linear_w, linear_b, *, Cx, Cg=0, Cs=0, use_vi, pe_on_vi=True,
             concat_wni=False, strided=False, num_heads=0):
    """Check a call's operands; return the kernel's arguments, its outputs
    and the tensors the arguments point into."""
    dev = feat_table.device
    if dev.type != "cuda":
        raise ValueError(f"fused_layer_eval takes CPU or CUDA tensors, got {dev}")
    W, Cpe, Ct = _widths(wn, pe, gd, linear_w, Cx=Cx, use_vi=use_vi, concat_wni=concat_wni)
    M, K = edges.nei.shape
    T, Wsz = edges.window_rows.shape
    MtK = edges.localT.shape[-1]
    N, Cf = feat_table.shape
    Gd = geo_table.shape[-1]
    O = linear_w.shape[-1]
    tensors = [feat_table, geo_table, edges.window_rows, edges.localT, center_xyz,
               linear_w, linear_b] + [t for pairs in (wn, pe, gd) for p in pairs for t in p]
    if use_vi:
        tensors.append(center_norm)
    if any(t.device != dev for t in tensors):
        raise ValueError("fused_layer_eval: all inputs must be on one device")
    if feat_table.dtype not in _DTYPES:
        raise ValueError(f"fused_layer_eval: the feature table must be float32 or "
                         f"bfloat16, got {feat_table.dtype}")
    if geo_table.dtype != torch.float32 or center_xyz.dtype != torch.float32 or (
            use_vi and center_norm.dtype != torch.float32):
        raise ValueError("fused_layer_eval: geometry and centres must be float32")
    if edges.window_rows.dtype != torch.int32 or edges.localT.dtype != torch.int32:
        raise ValueError("fused_layer_eval: window_rows and localT must be int32")
    if (Cf != Cx + Cg + Cs or Gd != (6 if use_vi else 3) or N != geo_table.shape[0]
            or center_xyz.shape != (M, 3) or (use_vi and center_norm.shape != (M, 3))
            or edges.localT.shape != (T, 1, MtK) or MtK % K or T * (MtK // K) != M
            or linear_b.shape != (O,) or (Cs and not strided)):
        raise ValueError(
            f"fused_layer_eval: shapes do not agree: feat_table {tuple(feat_table.shape)} "
            f"(Cx={Cx}, Cg={Cg}, Cs={Cs}), geo_table {tuple(geo_table.shape)}, centres "
            f"{tuple(center_xyz.shape)}, window_rows {tuple(edges.window_rows.shape)}, "
            f"localT {tuple(edges.localT.shape)}, M={M}, K={K}, linear_b "
            f"{tuple(linear_b.shape)}")
    if W > _MAX_W or K > _MAX_K:
        raise ValueError(f"fused_layer_eval: W={W}, K={K}; the kernel takes W <= {_MAX_W} "
                         f"and K <= {_MAX_K}")
    if gd and (num_heads <= 0 or Cx % num_heads or gd[0][0].shape[0] != Cg + Cpe
               or gd[-1][0].shape[1] != num_heads):
        raise ValueError(f"fused_layer_eval: guidance of {num_heads} heads over "
                         f"Cx={Cx}, query {Cg}+{Cpe} does not fit its MLP")
    bf16 = feat_table.dtype == torch.bfloat16
    feat_table, geo_table = feat_table.contiguous(), geo_table.contiguous()
    center_xyz = center_xyz.contiguous()
    center_norm = center_norm.contiguous() if use_vi else None
    pk = packed_weights(wn, pe, gd, linear_w, linear_b, bf16)
    mwn, mpe, mgd = pk.mlps
    out = torch.empty((M, O), dtype=feat_table.dtype, device=dev)
    short = torch.empty((M, Cs), dtype=feat_table.dtype, device=dev) if strided else None
    a = _Args(
        feats=feat_table.data_ptr(), geo=geo_table.data_ptr(),
        window_rows=edges.window_rows.data_ptr(), localT=edges.localT.data_ptr(),
        cxyz=center_xyz.data_ptr(), cnorm=center_norm.data_ptr() if use_vi else None,
        params=pk.params.data_ptr(), L=pk.L.data_ptr(), bias=pk.bias.data_ptr(),
        out=out.data_ptr(), shortcut=short.data_ptr() if strided else None,
        n_rows=N, Cf=Cf, Gd=Gd, wsz=Wsz, mtk=MtK, M=M, K=K, Cx=Cx, Cg=Cg, Cs=Cs, W=W,
        O=O, H=num_heads if gd else 0, Cpe=Cpe, Ct=Ct, lin=pk.params.numel(),
        use_vi=int(use_vi), pe_on_vi=int(pe_on_vi), concat_wni=int(concat_wni),
        strided=int(strided), bf16=int(bf16), wn=mwn, pe=mpe, gd=mgd)
    return a, out, short, (feat_table, geo_table, center_xyz, center_norm, pk)


def _shape(a: _Args) -> list[int]:
    out = (ctypes.c_longlong * 10)()
    _lib().layer_eval_shape(ctypes.byref(a), out)
    return list(out)


def launch_shape(*args, **kw) -> dict:
    """The launch shape kernel E picks for a call with these arguments (those
    of fused_layer_eval): points per block, O slices and columns per slice,
    channel-chunk ranges (blocks whose partial outputs meet in an f32
    workspace), blocks, dynamic shared memory bytes, threads per block,
    points per chunk of the per-edge stage, workspace bytes, and where the
    MLPs, contraction and projection run. Builds the library if needed."""
    sh = _shape(_prepare(*args, **kw)[0])
    return dict(points=sh[0], o_slices=sh[1], o_per_slice=sh[2], c_splits=sh[3],
                blocks=sh[4], smem=sh[5], threads=sh[6], edge_chunk_points=sh[8],
                workspace=sh[9], mlps="CUDA cores", contraction="CUDA cores",
                projection="mma.sync m16n8k16 bf16" if sh[7] else "CUDA cores f32")


def _pairs(mlp, layers) -> tuple:
    """The flat (w, b, w, b, ...) list of layer_eval_op -> (wn, pe, gd) pairs."""
    out, i = [], 0
    for n in layers:
        out.append([(mlp[i + 2 * j], mlp[i + 2 * j + 1]) for j in range(n)])
        i += 2 * n
    return tuple(out)


@torch.library.custom_op("pcf::layer_eval", mutates_args=())
def layer_eval_op(feat_table: torch.Tensor, geo_table: torch.Tensor, nei: torch.Tensor,
                  window_rows: torch.Tensor, localT: torch.Tensor, center_xyz: torch.Tensor,
                  center_norm: torch.Tensor | None, mlp: list[torch.Tensor],
                  layers: list[int], linear_w: torch.Tensor, linear_b: torch.Tensor,
                  Cx: int, Cg: int, Cs: int, use_vi: bool, pe_on_vi: bool, concat_wni: bool,
                  strided: bool, num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel E as an operator: the edges as their three tensors, the folded
    MLPs as one flat (w, b, ...) list with `layers` pairs each for the
    WeightNet, PE and guidance. The plain version for CPU tensors, the kernel
    for CUDA tensors (counted in fused_layer_eval.launches), else raise; the
    shortcut is [M, 0] when not strided."""
    args = (feat_table, geo_table, WindowedEdges(nei, window_rows, localT), center_xyz,
            center_norm, *_pairs(mlp, layers), linear_w, linear_b)
    kw = dict(Cx=Cx, Cg=Cg, Cs=Cs, use_vi=use_vi, pe_on_vi=pe_on_vi,
              concat_wni=concat_wni, strided=strided, num_heads=num_heads)
    if feat_table.device.type == "cpu":
        out, short = fused_layer_eval_plain(*args, **kw)
    else:
        a, out, short, _ = _prepare(*args, **kw)
        nbytes = _shape(a)[9]
        work = torch.empty(nbytes, dtype=torch.uint8, device=out.device) if nbytes else None
        err = _lib().layer_eval(ctypes.byref(a), None if work is None else work.data_ptr(),
                                torch.cuda.current_stream(feat_table.device).cuda_stream)
        if err:
            raise RuntimeError(f"fused_layer_eval launch failed with CUDA error {err}")
        fused_layer_eval.launches += 1
    return out, short if strided else feat_table.new_empty((nei.shape[0], 0))


@layer_eval_op.register_fake
def _(feat_table, geo_table, nei, window_rows, localT, center_xyz, center_norm, mlp, layers,
      linear_w, linear_b, Cx, Cg, Cs, use_vi, pe_on_vi, concat_wni, strided, num_heads):
    M = nei.shape[0]
    return (feat_table.new_empty((M, linear_w.shape[-1])),
            feat_table.new_empty((M, Cs if strided else 0)))


def fused_layer_eval(feat_table, geo_table, edges, center_xyz, center_norm, wn, pe, gd,
                     linear_w, linear_b, *, Cx: int, Cg: int = 0, Cs: int = 0,
                     use_vi: bool, pe_on_vi: bool = True, concat_wni: bool = False,
                     strided: bool = False, num_heads: int = 0):
    """Kernel E on one layer: feat_table [N, Cx+Cg+Cs] f32/bf16, geo_table
    [N, 3|6] f32, edges a WindowedEdges [M, K], centres [M, 3] f32, folded
    (w [ci, co], b [co]) pairs of the WeightNet, PE and guidance MLPs, the
    folded output linear [Ct*W, O] and [O]. Returns (out [M, O], shortcut
    [M, Cs] or None) in the table's dtype, through layer_eval_op."""
    mlp = [t for pairs in (wn, pe, gd) for p in pairs for t in p]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (
            feat_table, geo_table, center_xyz, center_norm, linear_w, linear_b, *mlp)
            if t is not None):
        raise RuntimeError("fused_layer_eval has no backward (inference only); "
                           "call it under torch.no_grad()")
    out, short = layer_eval_op(
        feat_table, geo_table, edges.nei, edges.window_rows, edges.localT, center_xyz,
        center_norm if use_vi else None, mlp, [len(wn), len(pe), len(gd)], linear_w,
        linear_b, Cx, Cg, Cs, use_vi, pe_on_vi, concat_wni, strided, num_heads)
    return out, short if strided else None


fused_layer_eval.launches = 0
