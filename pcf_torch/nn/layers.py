"""PointConv / PointConvFormer layers on the packed point layout.

Coordinates [N, 3], features [N, C], neighbour indices [M, K] or
WindowedEdges (M output points; M < N for strided layers). Validity masks
reach every BatchNorm, so padding never enters the statistics. Each layer is
the standard-geometry path of its pcf_tpu/nn/layers.py counterpart, with the
same sub-module names:

  PointConv             first-level conv, no bottleneck
  PointConvStridePE     bottleneck + PE + residual (strided or same-level)
  PCFLayer              guidance-modulated conv (the PCF block)
  PointConvTransposePE  decoder upsampling conv

With cfg.USE_PALLAS_KERNEL (nn/fused.fused_wins), a layer's gather +
guidance/PE + contraction + linear runs in one fused kernel
(FusedConvLinear); otherwise it runs the unfused ops and a LinearBN. With
cfg.fused_eval, an eval-mode layer on windowed edges runs its whole middle
as one launch of the whole-layer inference kernel (nn/fused_eval.py). With
cfg.flat_geom the hoisted stage geometry arrives k-major flat [M, K*c]
(models/backbone._stage_geometry); the WeightNet, PE and mlp_conv chain
takes it flat, and it is unfolded to [M, K, c] where it meets the features
(_flat_k, _unfold).
Training mode is the module's `training` flag. Dropout and DropPath draw
from an explicit torch.Generator that the train step hands every module with
`set_generator` (pcf_tpu folds a fresh key per step), never from the global
random state.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from pcf_torch.nn.fused import FusedConvLinear, fused_wins
from pcf_torch.nn.fused_eval import (fused_eval_ok, try_pcf_fused_eval,
                                     try_pointconv_fused_eval, try_stride_pe_fused_eval,
                                     try_transpose_fused_eval)
from pcf_torch.nn.guidance import MultiHeadGuidance
from pcf_torch.nn.norm import LinearBN, UnaryBlock
from pcf_torch.nn.weightnet import WeightNet
from pcf_torch.ops.gather import index_points, index_points_multi
from pcf_torch.ops.pconv import guided_contraction, pconv
from pcf_torch.ops.vi_transform import VI_coordinate_transform

_NOT_PORTED = ("cm_geom", "spatial_axis", "remat_layers", "remat_deconv")


def check_ported(cfg) -> None:
    """Raise for the config keys whose variants pcf_torch has not ported."""
    for key in _NOT_PORTED:
        if cfg.get(key):
            raise NotImplementedError(f"cfg.{key} is not ported to pcf_torch yet")
    if cfg.get("resolve_impl", "xla") not in ("pallas", "xla"):
        raise ValueError(f"resolve_impl must be 'pallas' or 'xla', got {cfg.resolve_impl!r}")


def dtype_of(cfg):
    """Computation dtype: bf16 activations when compute_dtype is bfloat16;
    parameters and BN statistics stay f32."""
    return torch.bfloat16 if cfg.get("compute_dtype") == "bfloat16" else None


def _highest(cfg) -> bool:
    return cfg.get("matmul_precision", "default") == "highest"


def set_generator(model: nn.Module, generator: torch.Generator | None) -> None:
    """Hand `generator` to every module of `model` that draws random numbers
    in training (dropout, DropPath)."""
    for m in model.modules():
        if hasattr(m, "generator"):
            m.generator = generator


_DRAWS: contextvars.ContextVar = contextvars.ContextVar("pcf_torch_draws", default=None)


@contextmanager
def kept_draws(draws: list, replay: bool):
    """Inside, every keep mask that dropout and DropPath draw is appended to
    `draws` (replay=False), or taken from its front instead of drawn
    (replay=True): the remat recompute of a block (nn/resstack.py) sees the
    masks its forward drew without rewinding the generator, whose state a
    CUDA graph capture cannot read. In this thread only: autograd runs a
    recompute in its own."""
    token = _DRAWS.set((draws, replay))
    try:
        yield
    finally:
        _DRAWS.reset(token)


def _keep(x, shape, generator, keep: float) -> torch.Tensor:
    """A bool mask of `shape`, each element True with probability `keep`,
    from torch.rand on the generator (or the recorded draw, see kept_draws)."""
    draws = _DRAWS.get()
    if draws is not None and draws[1]:
        return draws[0].pop(0)
    if generator is None:
        raise RuntimeError("dropout and DropPath in training draw from an explicit "
                           "torch.Generator: set one with nn.layers.set_generator")
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if draws is not None:
        draws[0].append(mask)
    return mask


def dropout(x, rate: float, training: bool, generator):
    """flax's Dropout: keep each element with probability 1 - rate, scaled
    by 1 / (1 - rate)."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    return torch.where(_keep(x, x.shape, generator, keep), x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """Stochastic depth on the residual branch: one keep/drop decision per
    call for the whole packed batch, scaled by 1/keep when kept."""

    generator = None

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        return torch.where(_keep(x, (), self.generator, keep), x / keep,
                           torch.zeros_like(x))


def _gathered_inputs(nei_inds, dense_xyz, center_xyz, feat_tensors,
                     localized_xyz=None, dense_xyz_norm=None, need_norm=False):
    """Every same-index gather of a layer, one gather per dtype group.
    Returns (localized_xyz [M,K,3], gathered_norm or None, gathered feature
    tensors in input order)."""
    reqs = []
    need_xyz = localized_xyz is None
    if need_xyz:
        reqs.append(dense_xyz)
    if need_norm:
        reqs.append(dense_xyz_norm)
    reqs.extend(feat_tensors)
    got = index_points_multi(reqs, nei_inds) if reqs else []
    i = 0
    if need_xyz:
        localized_xyz = got[i] - center_xyz[:, None, :]
        i += 1
    gathered_norm = None
    if need_norm:
        gathered_norm = got[i]
        i += 1
    return localized_xyz, gathered_norm, got[i:]


def _flat_k(weight_net_input, nei_inds) -> int:
    """K when the hoisted geometry arrived k-major flat [M, K*c], else 0."""
    if weight_net_input is not None and weight_net_input.dim() == 2:
        return int(nei_inds.shape[1])
    return 0


def _unfold(x, K: int):
    """[M, K*c] k-major flat -> [M, K, c]."""
    return x.reshape(x.shape[0], K, x.shape[-1] // K)


def _residual(layer, new_feat, sparse_feats, out_mask):
    """A bottleneck layer's end: DropPath(new_feat) plus the shortcut (through
    unary_shortcut where the width changes), then LeakyReLU(0.1)."""
    shortcut = (layer.unary_shortcut(sparse_feats, out_mask)
                if layer.in_channel != layer.out_channel else sparse_feats)
    return F.leaky_relu(layer.drop_path(new_feat) + shortcut, 0.1)


def _weightnet_input(cfg, localized_xyz, gathered_norm, center_norm, vi_features):
    """VI features (12-d) or the raw relative coordinates (3-d)."""
    if cfg.USE_VI:
        if vi_features is not None:
            return vi_features
        return VI_coordinate_transform(localized_xyz, gathered_norm, center_norm)
    return localized_xyz


class PointConv(nn.Module):
    """First-layer (VI-)PointConv without bottleneck."""

    generator = None  # dropout's, from set_generator

    def __init__(self, in_channel: int, out_channel: int, cfg,
                 weightnet: Sequence[int] = (9, 16), USE_VI: bool | None = None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.out_channel = out_channel
        self.use_vi = cfg.USE_VI if USE_VI is None else USE_VI
        dtype = dtype_of(cfg)
        wni_dim = cfg.point_dim + 9 if self.use_vi else cfg.point_dim
        pe_w = wni_dim if cfg.USE_PE else 0
        mid = weightnet[1]
        self.weightnet = WeightNet(wni_dim, mid, efficient=True,
                                   use_bn=cfg.BATCH_NORM, dtype=dtype)
        self.use_fused = fused_wins(cfg)
        linear_in = (in_channel + pe_w) * mid
        self.linear = (FusedConvLinear(linear_in, out_channel, use_bn=cfg.BATCH_NORM,
                                       dtype=dtype)
                       if self.use_fused else
                       LinearBN(linear_in, out_channel, use_bn=cfg.BATCH_NORM, dtype=dtype))

    def forward(self, dense_xyz, dense_feats, nei_inds, dense_xyz_norm=None,
                sparse_xyz=None, sparse_xyz_norm=None, vi_features=None,
                localized_xyz=None, dense_mask=None, sparse_mask=None):
        cfg = self.cfg
        dtype = dtype_of(cfg)
        if dtype is not None:
            dense_feats = dense_feats.to(dtype)
        center_xyz = sparse_xyz if sparse_xyz is not None else dense_xyz
        center_norm = sparse_xyz_norm if sparse_xyz is not None else dense_xyz_norm
        out_mask = sparse_mask if sparse_xyz is not None else dense_mask
        if fused_eval_ok(cfg, nei_inds, self.training):
            # the whole-layer inference kernel; dropout is the identity here
            return try_pointconv_fused_eval(self, cfg, dense_feats, dense_xyz,
                                            dense_xyz_norm, nei_inds, center_xyz,
                                            center_norm, self.use_vi), None
        localized_xyz, gathered_norm, gfeats = _gathered_inputs(
            nei_inds, dense_xyz, center_xyz, [] if self.use_fused else [dense_feats],
            localized_xyz=localized_xyz, dense_xyz_norm=dense_xyz_norm,
            need_norm=self.use_vi and vi_features is None)
        if self.use_vi:
            wni = (vi_features if vi_features is not None else
                   VI_coordinate_transform(localized_xyz, gathered_norm, center_norm))
        else:
            wni = localized_xyz
        flat_k = _flat_k(wni, nei_inds)
        weights = self.weightnet(wni, out_mask, flat_k)
        if flat_k:
            weights, wni = _unfold(weights, flat_k), _unfold(wni, flat_k)
        if self.use_fused:
            new_feat = self.linear(dense_feats, nei_inds, weights,
                                   additional_features=wni if cfg.USE_PE else None,
                                   mask=out_mask)
        else:
            gathered = gfeats[0]
            if cfg.USE_PE:
                gathered = torch.cat([gathered, wni], dim=-1)
            new_feat = self.linear(pconv(gathered, weights, _highest(cfg)), out_mask)
        new_feat = dropout(F.relu(new_feat), cfg.dropout_rate, self.training, self.generator)
        return new_feat, wni


class PointConvStridePE(nn.Module):
    """Bottlenecked PointConv with positional encoding and residual
    shortcut: the strided downsampling conv, and the same-level residual
    block."""

    generator = None  # dropout's, from set_generator

    def __init__(self, in_channel: int, out_channel: int, cfg,
                 weightnet: Sequence[int] = (9, 16)):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.in_channel, self.out_channel = in_channel, out_channel
        dtype = dtype_of(cfg)
        wni_dim = cfg.point_dim + 9 if cfg.USE_VI else cfg.point_dim
        mid = weightnet[1]
        c4 = out_channel // 4
        last_ch = min(c4, 32)
        self.use_fused = fused_wins(cfg)
        if in_channel != c4:
            self.unary1 = UnaryBlock(in_channel, c4, dtype=dtype)
        self.pe_convs = WeightNet(cfg.point_dim, last_ch, hidden_unit=(c4,),
                                  efficient=True, use_bn=cfg.BATCH_NORM, dtype=dtype)
        self.weightnet = WeightNet(wni_dim, mid, efficient=True,
                                   use_bn=cfg.BATCH_NORM, dtype=dtype)
        linear_in = (c4 + last_ch) * mid
        self.linear = (FusedConvLinear(linear_in, out_channel // 2,
                                       use_bn=cfg.BATCH_NORM, dtype=dtype)
                       if self.use_fused else
                       LinearBN(linear_in, out_channel // 2, use_bn=cfg.BATCH_NORM,
                                dtype=dtype))
        self.unary2 = UnaryBlock(out_channel // 2, out_channel, no_relu=True, dtype=dtype)
        if in_channel != out_channel:
            self.unary_shortcut = UnaryBlock(in_channel, out_channel, no_relu=True,
                                             dtype=dtype)
        self.drop_path = DropPath(cfg.drop_path_rate)

    def forward(self, dense_xyz, dense_feats, nei_inds, dense_xyz_norm=None,
                sparse_xyz=None, sparse_xyz_norm=None, vi_features=None,
                localized_xyz=None, dense_mask=None, sparse_mask=None):
        cfg = self.cfg
        dtype = dtype_of(cfg)
        if dtype is not None:
            dense_feats = dense_feats.to(dtype)
        strided = sparse_xyz is not None
        center_xyz = sparse_xyz if strided else dense_xyz
        center_norm = sparse_xyz_norm if strided else dense_xyz_norm
        out_mask = sparse_mask if strided else dense_mask

        feats_x = (self.unary1(dense_feats, dense_mask)
                   if self.in_channel != self.out_channel // 4 else dense_feats)
        if fused_eval_ok(cfg, nei_inds, self.training):
            new_feat, sparse_feats = try_stride_pe_fused_eval(
                self, cfg, feats_x, dense_feats, dense_xyz, dense_xyz_norm, nei_inds,
                center_xyz, center_norm, strided)
            return _residual(self, self.unary2(new_feat, out_mask), sparse_feats,
                             out_mask), None
        feat_reqs = ([] if self.use_fused else [feats_x]) + ([dense_feats] if strided else [])
        localized_xyz, gathered_norm, gfeats = _gathered_inputs(
            nei_inds, dense_xyz, center_xyz, feat_reqs,
            localized_xyz=localized_xyz, dense_xyz_norm=dense_xyz_norm,
            need_norm=cfg.USE_VI and vi_features is None)
        wni = _weightnet_input(cfg, localized_xyz, gathered_norm, center_norm,
                               vi_features)

        flat_k = _flat_k(wni, nei_inds)
        feat_pe = self.pe_convs(localized_xyz, out_mask, flat_k)
        weights = self.weightnet(wni, out_mask, flat_k)
        if flat_k:
            feat_pe, weights = _unfold(feat_pe, flat_k), _unfold(weights, flat_k)
        if self.use_fused:
            new_feat = self.linear(feats_x, nei_inds, weights,
                                   additional_features=feat_pe, mask=out_mask)
        else:
            gathered = torch.cat([gfeats[0], feat_pe], dim=-1)
            new_feat = self.linear(pconv(gathered, weights, _highest(cfg)), out_mask)
        new_feat = dropout(F.relu(new_feat), cfg.dropout_rate, self.training, self.generator)
        new_feat = self.unary2(new_feat, out_mask)

        # shortcut: max-pooled original features when strided
        sparse_feats = gfeats[-1].amax(dim=1) if strided else dense_feats
        return _residual(self, new_feat, sparse_feats, out_mask), wni


class PCFLayer(nn.Module):
    """PointConvFormer layer: conv weights modulated by feature-difference
    guidance."""

    generator = None  # dropout's, from set_generator

    def __init__(self, in_channel: int, out_channel: int, cfg,
                 weightnet: Sequence[int] = (9, 16), num_heads: int = 4,
                 guidance_feat_len: int = 32):
        super().__init__()
        check_ported(cfg)
        if cfg.attention_type != "subtraction":
            raise NotImplementedError(
                "attention_type other than 'subtraction' (MultiHeadGuidanceQK) "
                "is not ported to pcf_torch yet")
        self.cfg = cfg
        self.in_channel, self.out_channel = in_channel, out_channel
        dtype = dtype_of(cfg)
        wni_dim = cfg.point_dim + 9 if cfg.USE_VI else cfg.point_dim
        mid = weightnet[1]
        c4 = out_channel // 4
        self.use_fused = fused_wins(cfg)
        if in_channel != c4:
            self.unary1 = UnaryBlock(in_channel, c4, dtype=dtype)
        self.guidance_unary = UnaryBlock(c4, guidance_feat_len, no_relu=True, dtype=dtype)
        self.mlp_conv = LinearBN(wni_dim, guidance_feat_len, use_bn=cfg.BATCH_NORM,
                                 dtype=dtype)
        self.guidance_weight = MultiHeadGuidance(
            2 * guidance_feat_len, num_heads,
            layer_norm_guidance=cfg.layer_norm_guidance, use_bn=cfg.BATCH_NORM,
            dtype=dtype)
        self.weightnet = WeightNet(wni_dim, mid, efficient=True,
                                   use_bn=cfg.BATCH_NORM, dtype=dtype)
        self.linear = (FusedConvLinear(c4 * mid, out_channel // 2,
                                       use_bn=cfg.BATCH_NORM, dtype=dtype)
                       if self.use_fused else
                       LinearBN(c4 * mid, out_channel // 2, use_bn=cfg.BATCH_NORM,
                                dtype=dtype))
        self.unary2 = UnaryBlock(out_channel // 2, out_channel, no_relu=True, dtype=dtype)
        if in_channel != out_channel:
            self.unary_shortcut = UnaryBlock(in_channel, out_channel, no_relu=True,
                                             dtype=dtype)
        self.drop_path = DropPath(cfg.drop_path_rate)

    def forward(self, dense_xyz, dense_feats, nei_inds, dense_xyz_norm=None,
                sparse_xyz=None, sparse_xyz_norm=None, vi_features=None,
                localized_xyz=None, dense_mask=None, sparse_mask=None):
        cfg = self.cfg
        dtype = dtype_of(cfg)
        if dtype is not None:
            dense_feats = dense_feats.to(dtype)
        strided = sparse_xyz is not None
        center_xyz = sparse_xyz if strided else dense_xyz
        center_norm = sparse_xyz_norm if strided else dense_xyz_norm
        out_mask = sparse_mask if strided else dense_mask

        feats_x = (self.unary1(dense_feats, dense_mask)
                   if self.in_channel != self.out_channel // 4 else dense_feats)
        guidance_x = self.guidance_unary(feats_x, dense_mask)
        if fused_eval_ok(cfg, nei_inds, self.training):
            res = try_pcf_fused_eval(self, cfg, feats_x, guidance_x, dense_feats, dense_xyz,
                                     dense_xyz_norm, nei_inds, center_xyz, center_norm,
                                     strided)
            if res is not None:
                new_feat, sparse_feats = res
                return _residual(self, self.unary2(new_feat, out_mask), sparse_feats,
                                 out_mask), None
        feat_reqs = [guidance_x] + ([] if self.use_fused else [feats_x]) + (
            [dense_feats] if strided else [])
        localized_xyz, gathered_norm, gfeats = _gathered_inputs(
            nei_inds, dense_xyz, center_xyz, feat_reqs,
            localized_xyz=localized_xyz, dense_xyz_norm=dense_xyz_norm,
            need_norm=cfg.USE_VI and vi_features is None)
        wni = _weightnet_input(cfg, localized_xyz, gathered_norm, center_norm,
                               vi_features)

        # lift the VI coordinates to the guidance feature length
        flat_k = _flat_k(wni, nei_inds)
        feat_pe = F.relu(self.mlp_conv(wni, out_mask, flat_k))
        if flat_k:  # the guidance concat below joins the 3-D feature path
            feat_pe = _unfold(feat_pe, flat_k)
        guidance_feature = torch.cat([gfeats[0], feat_pe], dim=-1)
        if not strided:  # key = the centre itself
            guidance_key = guidance_feature[:, :1, :].expand_as(guidance_feature)
        else:  # key = max-pool over the neighbourhood
            guidance_key = guidance_feature.amax(dim=1, keepdim=True).expand_as(
                guidance_feature)
        guidance_score = self.guidance_weight(guidance_feature, guidance_key, out_mask)
        weights = self.weightnet(wni, out_mask, flat_k)
        if flat_k:
            weights = _unfold(weights, flat_k)

        if self.use_fused:
            new_feat = self.linear(feats_x, nei_inds, weights,
                                   guidance=guidance_score, mask=out_mask)
        else:
            new_feat = pconv(guided_contraction(gfeats[1], guidance_score), weights,
                             _highest(cfg))
            new_feat = self.linear(new_feat, out_mask)
        new_feat = dropout(F.relu(new_feat), cfg.dropout_rate, self.training, self.generator)
        new_feat = self.unary2(new_feat, out_mask)

        sparse_feats = gfeats[-1].amax(dim=1) if strided else dense_feats
        return _residual(self, new_feat, sparse_feats, out_mask), wni


class PointConvTransposePE(nn.Module):
    """Decoder upsampling conv: features from the sparse level onto the
    dense one, plus the encoder skip, then mlp2."""

    generator = None  # dropout's, from set_generator

    def __init__(self, in_channel: int, out_channel: int, cfg,
                 weightnet: Sequence[int] = (9, 16), mlp2: Sequence[int] | None = None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dtype = dtype_of(cfg)
        wni_dim = cfg.point_dim + 9 if cfg.USE_VI else cfg.point_dim
        mid = weightnet[1]
        pe_w = min(out_channel // 4, 32) if cfg.USE_PE else 0
        self.use_fused = fused_wins(cfg)
        if cfg.USE_PE:
            self.pe_convs = WeightNet(cfg.point_dim, pe_w, hidden_unit=(out_channel // 4,),
                                      efficient=True, use_bn=cfg.BATCH_NORM, dtype=dtype)
        self.weightnet = WeightNet(wni_dim, mid, efficient=True,
                                   use_bn=cfg.BATCH_NORM, dtype=dtype)
        linear_in = (in_channel + pe_w) * mid
        self.linear = (FusedConvLinear(linear_in, out_channel, use_bn=cfg.BATCH_NORM,
                                       dtype=dtype)
                       if self.use_fused else
                       LinearBN(linear_in, out_channel, use_bn=cfg.BATCH_NORM, dtype=dtype))
        self.n_mlp2 = len(mlp2) - 1 if mlp2 else 0
        prev = out_channel
        for i in range(1, self.n_mlp2 + 1):
            self.add_module(f"mlp2_convs_{i - 1}", LinearBN(
                prev, mlp2[i], use_bn=cfg.BATCH_NORM, dtype=dtype))
            prev = mlp2[i]

    def forward(self, sparse_xyz, sparse_feats, nei_inds, sparse_xyz_norm=None,
                dense_xyz=None, dense_xyz_norm=None, dense_feats=None,
                vi_features=None, dense_mask=None, sparse_mask=None):
        cfg = self.cfg
        dtype = dtype_of(cfg)
        if dtype is not None:
            sparse_feats = sparse_feats.to(dtype)
            if dense_feats is not None:
                dense_feats = dense_feats.to(dtype)
        out_mask = dense_mask
        if fused_eval_ok(cfg, nei_inds, self.training):
            new_feat = try_transpose_fused_eval(self, cfg, sparse_feats, sparse_xyz,
                                                sparse_xyz_norm, nei_inds, dense_xyz,
                                                dense_xyz_norm)
            return self._head(new_feat, dense_feats, out_mask), None
        localized_xyz, gathered_norm, gfeats = _gathered_inputs(
            nei_inds, sparse_xyz, dense_xyz, [] if self.use_fused else [sparse_feats],
            dense_xyz_norm=sparse_xyz_norm,
            need_norm=cfg.USE_VI and vi_features is None)
        wni = _weightnet_input(cfg, localized_xyz, gathered_norm, dense_xyz_norm,
                               vi_features)
        # decoder edges are never hoisted, so the flat forms do not arrive
        # here from the model; the layer takes them as the others do
        feat_pe = None
        if cfg.USE_PE:
            pe_k = _flat_k(localized_xyz, nei_inds)
            feat_pe = self.pe_convs(localized_xyz, out_mask, pe_k)
            if pe_k:
                feat_pe = _unfold(feat_pe, pe_k)
        flat_k = _flat_k(wni, nei_inds)
        weights = self.weightnet(wni, out_mask, flat_k)
        if flat_k:
            weights = _unfold(weights, flat_k)
        if self.use_fused:
            new_feat = self.linear(sparse_feats, nei_inds, weights,
                                   additional_features=feat_pe, mask=out_mask)
        else:
            gathered = gfeats[0]
            if feat_pe is not None:
                gathered = torch.cat([gathered, feat_pe], dim=-1)
            new_feat = self.linear(pconv(gathered, weights, _highest(cfg)), out_mask)
        return self._head(F.relu(new_feat), dense_feats, out_mask), wni

    def _head(self, new_feat, dense_feats, out_mask):
        """The encoder skip, dropout and mlp2 after the upsampling conv."""
        if dense_feats is not None:
            new_feat = new_feat + dense_feats
        new_feat = dropout(new_feat, self.cfg.dropout_rate, self.training, self.generator)
        for i in range(self.n_mlp2):
            new_feat = F.relu(getattr(self, f"mlp2_convs_{i}")(new_feat, out_mask))
        return new_feat
