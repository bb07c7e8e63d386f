"""Point-cloud classification: PCF backbone + masked global max-pool + a
2-layer head (pcf_tpu/models/classification.py; the reference's
tests_pointconv/test_modelnet10.py). With a packed batch of several clouds,
`bids` (per-point cloud ids at the coarsest level) segments the pool;
without it the whole batch is one cloud.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from pcf_torch.models.backbone import PCF_Backbone
from pcf_torch.nn.init import Dense
from pcf_torch.nn.layers import dropout
from pcf_torch.nn.norm import LinearBN


class PointConvFormer_Classification(nn.Module):
    generator = None  # dropout_fc's, from nn.layers.set_generator

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.pcf_backbone = PCF_Backbone(cfg)
        self.fc1 = LinearBN(cfg.feat_dim[cfg.num_level - 1], cfg.base_dim * 2,
                            use_bn=cfg.BATCH_NORM)
        self.fc2 = Dense(cfg.base_dim * 2, cfg.num_classes)

    def forward(self, features, pointclouds, edges_self, edges_forward, norms,
                masks=None, bids=None) -> torch.Tensor:
        """[num_clouds, num_classes] logits: one cloud without `bids`, else
        cfg.max_clouds (default cfg.BATCH_SIZE, 8) of them."""
        cfg = self.cfg
        feats = self.pcf_backbone(features, pointclouds, edges_self, edges_forward, norms,
                                  masks=masks)[-1]  # [N_top, C]
        mask = (masks[-1] if masks is not None
                else torch.ones(feats.shape[0], dtype=torch.bool, device=feats.device))
        neg_inf = torch.finfo(feats.dtype).min
        if bids is None:
            pooled = torch.where(mask[:, None], feats, neg_inf).amax(0, keepdim=True)
        else:
            n_clouds = cfg.get("max_clouds", int(cfg.get("BATCH_SIZE", 8)))
            onehot = (bids[:, None] == torch.arange(n_clouds, device=bids.device)) \
                & mask[:, None]
            pooled = torch.where(onehot[:, :, None], feats[:, None, :], neg_inf).amax(0)
        x = F.relu(self.fc1(pooled))
        x = dropout(x, cfg.dropout_fc, self.training, self.generator)
        return self.fc2(x)

    def forward_batch(self, batch, bids=None):
        """The forward on a PackedPyramid (its segmentation-only edges left
        out)."""
        return self(batch.feats, list(batch.points), list(batch.edges_self),
                    list(batch.edges_forward), list(batch.norms), masks=list(batch.masks),
                    bids=bids)
