"""Layer-side wiring of kernel E, the whole-layer inference kernel
(ops/kernels/layer_eval.py), as pcf_tpu/nn/fused_eval.py wires its Pallas
kernel.

Each conv layer (nn/layers.py) asks `fused_eval_ok` at the top of its
compute; when it passes (inference, cfg.fused_eval, windowed edges with the
kernel's tiling), the layer's `try_*` helper reads the layer's own
submodules, folds every Linear+BatchNorm pair into one affine transform
(running-statistic BN at inference is a constant scale and shift, the
reference's replace_batchnorm), and runs the layer's middle as one launch of
kernel E. unary1, guidance_unary, unary2, unary_shortcut, the skip add and
mlp2 stay outside the kernel.

The folds are kept on the layer between calls, so the path launches no fold
kernels in steady state; kernel E's packed form of them
(layer_eval.packed_weights) is kept on the fold's linear weight in the same
way, so a steady-state call packs nothing either. The cache
(ops/kernels/derived.cached) is keyed on every folded tensor's data_ptr and
_version, and holds those tensors' storages: an in-place update (a BN running
statistic, load_state_dict) bumps _version, a train step (eager or replayed)
bumps it through derived.weights_written, and a replaced tensor has another
address, since the cached storage keeps its old one taken. Each folds
again. (A change made through `.data` bypasses _version; nothing in
pcf_torch makes one.)

A layer's `linear` may be a LinearBN or a FusedConvLinear (USE_PALLAS_KERNEL);
both fold. pcf_tpu's fold reads only the LinearBN layout.
"""

from __future__ import annotations

import torch

from pcf_torch.nn.fused import FusedConvLinear
from pcf_torch.ops.kernels.derived import cached
from pcf_torch.ops.kernels.layer_eval import fused_layer_eval
from pcf_torch.ops.window import WindowedEdges

_BN_EPS = 1e-5


def fused_eval_ok(cfg, nei_inds, training: bool) -> bool:
    """Gate: inference only, cfg.fused_eval, no spatial sharding, windowed
    edges with kernel-compatible tiling (pcf_tpu's gate; it also refuses
    flax's init, which has no counterpart here)."""
    if training or not cfg.get("fused_eval") or cfg.get("spatial_axis"):
        return False
    if not isinstance(nei_inds, WindowedEdges):
        return False
    M, K = nei_inds.nei.shape
    MtK = nei_inds.localT.shape[-1]
    T = nei_inds.window_rows.shape[0]
    return K % 8 == 0 and MtK % 128 == 0 and M == T * (MtK // K)


def _fold_linbn(mod):
    """A LinearBN or FusedConvLinear -> one (w [in, out], b [out]) in f32:
    y = (x @ w + b - mean) * scale / sqrt(var + eps) + beta."""
    if isinstance(mod, FusedConvLinear):
        w, b = mod.weight.float(), mod.bias.float()
    else:
        w, b = mod.c.weight.float().t(), mod.c.bias.float()
    if mod.bn is not None:
        bn = mod.bn
        s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + _BN_EPS)
        w, b = w * s, (b - bn.running_mean.float()) * s + bn.bias.float()
    return w.detach().contiguous(), b.detach()


def _fold_weightnet(weightnet):
    """WeightNet -> its folded (w, b) pairs, input first."""
    core = weightnet.core
    return [_fold_linbn(getattr(core, f"mlp_convs_{i}")) for i in range(core.n)]


def _fold_linbn_named(layer, name):
    return _fold_linbn(getattr(layer, name))


def _fold_guidance(layer, name="guidance_weight"):
    g = getattr(layer, name)
    return [_fold_linbn(g.mlp_0), _fold_linbn(g.mlp_1)]


def _folded(layer, names, fold):
    """fold() of the layer's submodules `names`, kept on the layer until a
    tensor of theirs changes (see the module docstring)."""
    tensors = [t for n in names for m in (getattr(layer, n),)
               for t in (*m.parameters(), *m.buffers())]
    return cached(layer.__dict__, "_fused_eval_folds", tensors, fold)


def _geo_table(xyz, norms, use_vi):
    xyz = xyz.float()
    return torch.cat([xyz, norms.float()], dim=-1) if use_vi else xyz


def _centres(center_xyz, center_norm, use_vi):
    return center_xyz.float(), center_norm.float() if use_vi else None


def try_pcf_fused_eval(layer, cfg, feats_x, guidance_x, dense_feats, dense_xyz, norms,
                       nei_inds, center_xyz, center_norm, strided: bool):
    """PCFLayer's middle -> (output before unary2, shortcut features), or
    None where the kernel does not cover the layer (LayerNorm guidance)."""
    if cfg.attention_type != "subtraction" or cfg.layer_norm_guidance:
        return None
    wn, pe, gd, (lw, lb) = _folded(
        layer, ("weightnet", "mlp_conv", "guidance_weight", "linear"),
        lambda: (_fold_weightnet(layer.weightnet), [_fold_linbn_named(layer, "mlp_conv")],
                 _fold_guidance(layer), _fold_linbn_named(layer, "linear")))
    parts = [feats_x, guidance_x] + ([dense_feats] if strided else [])
    out, short = fused_layer_eval(
        torch.cat(parts, dim=-1), _geo_table(dense_xyz, norms, cfg.USE_VI), nei_inds,
        *_centres(center_xyz, center_norm, cfg.USE_VI), wn, pe, gd, lw, lb,
        Cx=feats_x.shape[-1], Cg=guidance_x.shape[-1],
        Cs=dense_feats.shape[-1] if strided else 0, use_vi=cfg.USE_VI, pe_on_vi=True,
        strided=strided, num_heads=gd[-1][0].shape[-1])
    return out, (short if strided else dense_feats)


def try_stride_pe_fused_eval(layer, cfg, feats_x, dense_feats, dense_xyz, norms,
                             nei_inds, center_xyz, center_norm, strided: bool):
    """PointConvStridePE's middle -> (output before unary2, shortcut features)."""
    wn, pe, (lw, lb) = _folded(
        layer, ("weightnet", "pe_convs", "linear"),
        lambda: (_fold_weightnet(layer.weightnet), _fold_weightnet(layer.pe_convs),
                 _fold_linbn_named(layer, "linear")))
    table = torch.cat([feats_x, dense_feats], dim=-1) if strided else feats_x
    out, short = fused_layer_eval(
        table, _geo_table(dense_xyz, norms, cfg.USE_VI), nei_inds,
        *_centres(center_xyz, center_norm, cfg.USE_VI), wn, pe, [], lw, lb,
        Cx=feats_x.shape[-1], Cs=dense_feats.shape[-1] if strided else 0,
        use_vi=cfg.USE_VI, pe_on_vi=False, strided=strided)
    return out, (short if strided else dense_feats)


def try_pointconv_fused_eval(layer, cfg, dense_feats, dense_xyz, norms, nei_inds,
                             center_xyz, center_norm, use_vi):
    """PointConv's middle: contraction over [feats | WeightNet input]."""
    wn, (lw, lb) = _folded(
        layer, ("weightnet", "linear"),
        lambda: (_fold_weightnet(layer.weightnet), _fold_linbn_named(layer, "linear")))
    out, _ = fused_layer_eval(
        dense_feats, _geo_table(dense_xyz, norms, use_vi), nei_inds,
        *_centres(center_xyz, center_norm, use_vi), wn, [], [], lw, lb,
        Cx=dense_feats.shape[-1], use_vi=use_vi, concat_wni=bool(cfg.USE_PE))
    return out


def try_transpose_fused_eval(layer, cfg, sparse_feats, sparse_xyz, sparse_norms,
                             nei_inds, dense_xyz, dense_norm):
    """PointConvTransposePE's upsampling conv (skip add and mlp2 stay outside)."""
    names = ("weightnet", "linear") + (("pe_convs",) if cfg.USE_PE else ())
    wn, pe, (lw, lb) = _folded(
        layer, names,
        lambda: (_fold_weightnet(layer.weightnet),
                 _fold_weightnet(layer.pe_convs) if cfg.USE_PE else [],
                 _fold_linbn_named(layer, "linear")))
    out, _ = fused_layer_eval(
        sparse_feats, _geo_table(sparse_xyz, sparse_norms, cfg.USE_VI), nei_inds,
        *_centres(dense_xyz, dense_norm, cfg.USE_VI), wn, pe, [], lw, lb,
        Cx=sparse_feats.shape[-1], use_vi=cfg.USE_VI, pe_on_vi=False)
    return out
