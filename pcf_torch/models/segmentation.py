"""Segmentation model: PCF backbone + transpose-conv decoder + FC head.

The decoder walks the pyramid from the coarsest level back to level 0 with
PointConvTransposePE (encoder features skip-added), optional residual
blocks, then fc1 (+BN) -> dropout -> fc2, as
pcf_tpu/models/segmentation.py. cfg.remat_layers and cfg.remat_deconv
recompute decoder layers in the backward (models/backbone.maybe_remat).
"""

from __future__ import annotations

from torch import nn
from torch.nn import functional as F

from pcf_torch.models.backbone import (PCF_Backbone, _skip_stage_geometry, _stage_geometry,
                                      maybe_remat, remat_call)
from pcf_torch.nn.init import Dense
from pcf_torch.nn.layers import (PointConvStridePE, PointConvTransposePE, dropout,
                                 dtype_of)
from pcf_torch.nn.norm import LinearBN


class PointConvFormer_Segmentation(nn.Module):
    generator = None  # dropout_fc's, from nn.layers.set_generator

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        L = cfg.num_level
        wni_dim = cfg.point_dim + 9 if cfg.USE_VI else cfg.point_dim
        weightnet = (wni_dim, cfg.mid_dim_back)
        self.resblocks_back = cfg.get("resblocks_back", [0] * L)
        self.pcf_backbone = PCF_Backbone(cfg)
        self.remat = {c for c in (PointConvTransposePE, PointConvStridePE)
                      if maybe_remat(c, cfg)}  # classes of decoder layers recomputed
        for idx, i in enumerate(range(L - 2, -1, -1)):
            in_ch = cfg.feat_dim[i + 1]
            out_ch = cfg.base_dim if i == 0 else cfg.feat_dim[i]
            self.add_module(f"pointdeconv_{idx}", PointConvTransposePE(
                in_ch, out_ch, cfg, weightnet, (out_ch, out_ch)))
            # the reference gates on resblocks[i] but counts resblocks_back[i]
            if cfg.resblocks[i] != 0:
                for j in range(self.resblocks_back[i]):
                    self.add_module(f"pointdeconv_res_{idx}_{j}", PointConvStridePE(
                        out_ch, out_ch, cfg, weightnet))
        self.fc1 = LinearBN(cfg.base_dim, cfg.base_dim, use_bn=cfg.BATCH_NORM,
                            dtype=dtype_of(cfg))
        self.fc2 = Dense(cfg.base_dim, cfg.num_classes)

    def forward(self, features, pointclouds, edges_self, edges_forward,
                edges_propagate, norms, masks=None):
        cfg = self.cfg
        L = cfg.num_level
        masks = [None] * L if masks is None else masks
        feat_list = self.pcf_backbone(features, pointclouds, edges_self,
                                      edges_forward, norms, masks=masks)
        feat = feat_list[-1]
        for idx, i in enumerate(range(L - 2, -1, -1)):
            feat, _ = remat_call(
                getattr(self, f"pointdeconv_{idx}"), PointConvTransposePE in self.remat,
                pointclouds[i + 1], feat, edges_propagate[i], norms[i + 1],
                pointclouds[i], norms[i], feat_list[i], None, masks[i], masks[i + 1])
            if cfg.resblocks[i] != 0 and self.resblocks_back[i] > 0:
                localized, vi_features = None, None
                if not _skip_stage_geometry(cfg, edges_self[i], self.training,
                                            PointConvStridePE):
                    localized, vi_features = _stage_geometry(
                        pointclouds[i], edges_self[i], norms[i], use_vi=cfg.USE_VI, cfg=cfg)
                for j in range(self.resblocks_back[i]):
                    feat, _ = remat_call(
                        getattr(self, f"pointdeconv_res_{idx}_{j}"),
                        PointConvStridePE in self.remat, pointclouds[i], feat,
                        edges_self[i], norms[i], None, None, vi_features, localized,
                        masks[i], None)
        fc = F.relu(self.fc1(feat, masks[0]))
        fc = dropout(fc, cfg.dropout_fc, self.training, self.generator)
        return self.fc2(fc)

    def forward_batch(self, batch):
        """The forward on a PackedPyramid."""
        return self(batch.feats, list(batch.points), list(batch.edges_self),
                    list(batch.edges_forward), list(batch.edges_propagate),
                    list(batch.norms), masks=list(batch.masks))
