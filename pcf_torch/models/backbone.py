"""PCF encoder backbone: level-1 PointConvs (or one MLP), then per level a
strided PCFLayer / PointConvStridePE and its residual blocks, over the packed
pyramid without a batch dim:

  features [N0, C], pointclouds[l] [Nl, 3], edges_self[l] [Nl, K],
  edges_forward[l] [N(l+1), K], norms[l] [Nl, 3], masks[l] [Nl] bool.

The localized offsets and VI features of a level are computed once per stage
and shared by its residual blocks, as in pcf_tpu/models/backbone.py: with
cfg.cm_geom channel-major from the window resolve's rows, with
cfg.flat_geom in k-major flat layout through the flat window resolve, and
not at all where every block of the stage takes the whole-layer inference
kernel (cfg.fused_eval), which computes its own.

cfg.transformer_type other than "PCF" builds PointTransformerLayers in
place of the PCFLayers (strided convs and residual blocks past
guided_level). cfg.remat_layers recomputes every strided and decoder conv
layer in the backward, cfg.remat_deconv only the decoder's transpose convs
(maybe_remat, remat_call): with the checkpoint machinery of
nn/resstack.py, which replays the forward's random draws and moves the BN
running statistics once.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from pcf_torch.nn.fused_eval import fused_eval_ok
from pcf_torch.nn.layers import (PCFLayer, PointConv, PointConvStridePE, PointConvTransposePE,
                                 PointTransformerLayer, check_ported, dtype_of)
from pcf_torch.nn.norm import LinearBN
from pcf_torch.nn.resstack import ResBlockStack, remat_contexts
from pcf_torch.nn.sharded import spatial_full
from pcf_torch.ops.gather import index_points, index_points_multi
from pcf_torch.ops.vi_transform import (VI_coordinate_transform, localize_cm, localize_flat,
                                        split_geom_flat, vi_transform_cm, vi_transform_flat)
from pcf_torch.ops.window import WindowedEdges, windowed_take_cm, windowed_take_flat


def maybe_remat(cls, cfg) -> bool:
    """Whether layers of class `cls` are recomputed in the backward
    (pcf_tpu's maybe_remat, models/backbone.py:36-58): every one under
    cfg.remat_layers, the decoder's PointConvTransposePE under
    cfg.remat_deconv. The class is tested by identity, not by name."""
    return bool(cfg.get("remat_layers")) or (
        bool(cfg.get("remat_deconv")) and cls is PointConvTransposePE)


def remat_call(layer: nn.Module, remat: bool, *args):
    """layer(*args), recomputed in the backward when `remat` and a gradient
    is being built."""
    if remat and torch.is_grad_enabled():
        # the port draws from no global random state, so checkpoint need
        # not stash it
        return checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=remat_contexts)
    return layer(*args)


def _skip_stage_geometry(cfg, nei_inds, training, block_cls) -> bool:
    """True when every block of the stage takes the whole-layer inference
    kernel, which computes VI from the geometry itself: the stage tensors
    would go unused."""
    if not fused_eval_ok(cfg, nei_inds, training):
        return False
    if block_cls is PCFLayer:
        return cfg.attention_type == "subtraction" and not cfg.layer_norm_guidance
    return True


def _stage_geometry(xyz, nei_inds, norms, use_vi, cfg=None):
    """Per-stage geometry shared by every same-level residual block: the
    localized neighbour offsets and (with USE_VI) the VI features, from one
    combined gather, cast to the compute dtype (the geometry arithmetic
    itself stays f32). With cfg.flat_geom and windowed edges both are k-major
    flat, [M, K*3] and [M, K*12], from the flat resolve, and carry no
    gradient (pcf_tpu stops it there too). Under spatial sharding
    (nn/sharded.py) xyz and norms are this rank's rows: the neighbours are
    gathered from their full tables, the centres are the rows themselves."""
    dtype = None if cfg is None else dtype_of(cfg)
    src_xyz, src_norms = spatial_full(xyz, norms if use_vi else None)
    if cfg is not None and cfg.get("cm_geom") and isinstance(nei_inds, WindowedEdges):
        if use_vi:
            g6 = windowed_take_cm(torch.cat([src_xyz, src_norms], -1), nei_inds)
            loc_cm = localize_cm(g6[:3], xyz)
            localized = loc_cm.permute(1, 2, 0)
            vi = vi_transform_cm(loc_cm, g6[3:], norms).permute(1, 2, 0)
            if dtype is not None:
                localized, vi = localized.to(dtype), vi.to(dtype)
            return localized, vi
        localized = localize_cm(windowed_take_cm(src_xyz, nei_inds), xyz).permute(1, 2, 0)
        return (localized if dtype is None else localized.to(dtype)), None
    if cfg is not None and cfg.get("flat_geom") and isinstance(nei_inds, WindowedEdges):
        if use_vi:
            gx, gn = split_geom_flat(windowed_take_flat(torch.cat([src_xyz, src_norms], -1),
                                                        nei_inds))
            localized = localize_flat(gx, xyz)
            vi = vi_transform_flat(localized, gn, norms)
            if dtype is not None:
                localized, vi = localized.to(dtype), vi.to(dtype)
            return localized, vi
        localized = localize_flat(windowed_take_flat(src_xyz, nei_inds), xyz)
        return (localized if dtype is None else localized.to(dtype)), None
    if use_vi:
        gx, gn = index_points_multi([src_xyz, src_norms], nei_inds)
        localized = gx - xyz[:, None, :]
        vi = VI_coordinate_transform(localized, gn, norms)
        if dtype is not None:
            localized, vi = localized.to(dtype), vi.to(dtype)
        return localized, vi
    localized = index_points(src_xyz, nei_inds) - xyz[:, None, :]
    return (localized if dtype is None else localized.to(dtype)), None


class PCF_Backbone(nn.Module):
    def __init__(self, cfg, input_feat_dim: int = 3):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.remat = set()  # names of the layers maybe_remat recomputes
        wni_dim = cfg.point_dim + 9 if cfg.USE_VI else cfg.point_dim
        in_feat_dim = input_feat_dim + 3 if cfg.USE_XYZ else input_feat_dim
        if cfg.use_level_1:
            self.selfpointconv = PointConv(in_feat_dim, cfg.base_dim, cfg,
                                           (wni_dim, cfg.mid_dim[0]))
            if maybe_remat(PointConv, cfg):
                self.remat.add("selfpointconv")
            self.selfpointconv_res = ResBlockStack(
                PointConvStridePE, 2, cfg.base_dim, cfg, (wni_dim, cfg.mid_dim[0]))
        else:
            self.selfmlp = LinearBN(in_feat_dim, cfg.base_dim, use_bn=cfg.BATCH_NORM,
                                    dtype=dtype_of(cfg))
        for i in range(1, cfg.num_level):
            in_ch, out_ch = cfg.feat_dim[i - 1], cfg.feat_dim[i]
            weightnet = (wni_dim, cfg.mid_dim[i])
            if i <= cfg.guided_level:
                conv = PointConvStridePE(in_ch, out_ch, cfg, weightnet)
            elif cfg.transformer_type == "PCF":
                conv = PCFLayer(in_ch, out_ch, cfg, weightnet, cfg.num_heads)
            else:
                conv = PointTransformerLayer(in_ch, out_ch, cfg, cfg.num_heads)
            self.add_module(f"pointconv_{i - 1}", conv)
            if maybe_remat(type(conv), cfg):
                self.remat.add(f"pointconv_{i - 1}")
            if cfg.transformer_type != "PCF" and i > cfg.guided_level:
                for j in range(cfg.resblocks[i]):
                    self.add_module(f"pointconv_res_{i - 1}_{j}", PointTransformerLayer(
                        out_ch, out_ch, cfg, cfg.num_heads))
            elif cfg.resblocks[i] > 0:
                block_cls = PointConvStridePE if i <= cfg.guided_level else PCFLayer
                self.add_module(f"pointconv_res_{i - 1}", ResBlockStack(
                    block_cls, cfg.resblocks[i], out_ch, cfg, weightnet, cfg.num_heads))

    def forward(self, features, pointclouds, edges_self, edges_forward, norms,
                masks=None):
        cfg = self.cfg
        masks = [None] * cfg.num_level if masks is None else masks
        feat = (torch.cat([features, pointclouds[0]], dim=-1)
                if cfg.USE_XYZ else features)
        if cfg.use_level_1:
            localized0, vi_features = self._geometry(pointclouds[0], edges_self[0],
                                                     norms[0], PointConvStridePE)
            feat, _ = remat_call(
                self.selfpointconv, "selfpointconv" in self.remat,
                pointclouds[0], feat, edges_self[0], norms[0], None, None,
                vi_features, localized0, masks[0], None)
            feat = self.selfpointconv_res(
                pointclouds[0], feat, edges_self[0], norms[0],
                vi_features=vi_features if cfg.USE_VI else None,
                localized_xyz=localized0, mask=masks[0])
        else:
            feat = F.relu(self.selfmlp(feat, masks[0]))

        feat_list = [feat]
        for i in range(1, cfg.num_level):
            name = f"pointconv_{i - 1}"
            conv = getattr(self, name)
            if isinstance(conv, PointTransformerLayer):
                feat = remat_call(conv, name in self.remat, pointclouds[i - 1],
                                  feat_list[-1], edges_forward[i - 1], pointclouds[i],
                                  masks[i - 1], masks[i])
                for j in range(cfg.resblocks[i]):
                    feat = getattr(self, f"pointconv_res_{i - 1}_{j}")(
                        pointclouds[i], feat, edges_self[i], dense_mask=masks[i])
                feat_list.append(feat)
                continue
            feat, _ = remat_call(
                conv, name in self.remat, pointclouds[i - 1], feat_list[-1],
                edges_forward[i - 1], norms[i - 1], pointclouds[i], norms[i], None, None,
                masks[i - 1], masks[i])
            if cfg.resblocks[i] > 0:
                block_cls = PointConvStridePE if i <= cfg.guided_level else PCFLayer
                localized, vi_features = self._geometry(pointclouds[i], edges_self[i],
                                                        norms[i], block_cls)
                feat = getattr(self, f"pointconv_res_{i - 1}")(
                    pointclouds[i], feat, edges_self[i], norms[i],
                    vi_features=vi_features, localized_xyz=localized, mask=masks[i])
            feat_list.append(feat)
        return feat_list

    def _geometry(self, xyz, nei_inds, norms, block_cls):
        """The stage geometry of a level's blocks, or (None, None) where they
        all take the whole-layer inference kernel."""
        if _skip_stage_geometry(self.cfg, nei_inds, self.training, block_cls):
            return None, None
        return _stage_geometry(xyz, nei_inds, norms, use_vi=self.cfg.USE_VI, cfg=self.cfg)
