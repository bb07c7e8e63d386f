"""Segmentation loss: weighted cross-entropy with label smoothing + ignore.

pcf_tpu/train/loss.py's semantics, which are torch's
nn.CrossEntropyLoss(weight, ignore_index, label_smoothing) with the
'weighted mean' reduction: each point's loss is scaled by its target class's
weight and the sum is divided by the summed weights. Padded rows are left
out through the validity mask as well as through ignore_label. The psum of
pcf_tpu's `axis_name` (point-dim sharding) waits for the parallel port.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None,
                       class_weights: torch.Tensor | None = None,
                       label_smoothing: float = 0.0, ignore_label: int = -100):
    """logits [N, C], labels [N] int, mask [N] bool -> (scalar loss, number
    of valid points). Safe when every point is ignored (loss 0)."""
    num_classes = logits.shape[-1]
    valid = labels != ignore_label
    if mask is not None:
        valid = valid & mask
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()

    logp = F.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)),
                         dim=-1)
    nll = -logp.gather(-1, safe[:, None])[:, 0]
    if class_weights is not None:
        cw = class_weights.to(device=logits.device, dtype=logp.dtype)
        wy = cw[safe]
    else:
        cw = None
        wy = torch.ones_like(nll)
    wy = torch.where(valid, wy, torch.zeros_like(wy))

    # torch's formula: (1 - eps) * w_y * nll + eps * sum_c(w_c * -logp_c) / C,
    # reduced by sum(w_y)
    per = (1.0 - label_smoothing) * wy * nll
    if label_smoothing > 0.0:
        neg = -logp if cw is None else -logp * cw[None, :]
        smooth = neg.sum(-1) / num_classes
        per = per + label_smoothing * torch.where(valid, smooth, torch.zeros_like(smooth))
    loss = per.sum() / wy.sum().clamp_min(1e-8)
    return loss, valid.sum()
