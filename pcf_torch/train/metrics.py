"""IoU metrics as histograms, and a running average (pcf_tpu/train/metrics.py).

The histograms stay on the device: a train step returns them and the loop
reads them back only at a print boundary.
"""

from __future__ import annotations

import torch


def intersection_and_union(pred: torch.Tensor, target: torch.Tensor, num_classes: int,
                           ignore_label: int = -100, mask: torch.Tensor | None = None):
    """pred, target [N] int -> (intersection [C], union [C], target count [C])
    in float32; points whose target is ignore_label, or that the mask
    leaves out, count nowhere."""
    valid = target != ignore_label
    if mask is not None:
        valid = valid & mask
    # invalid points go to two overflow bins, so no shape depends on the data
    # (a boolean selection would wait for the device)
    t = torch.where(valid, target.long(), num_classes)
    p = torch.where(valid, pred.long(), num_classes + 1)

    def hist(x):
        h = torch.zeros(num_classes + 2, dtype=torch.long, device=x.device)
        return h.scatter_add_(0, x, torch.ones_like(x))[:num_classes].float()

    area_t = hist(t)
    area_p = hist(p)
    inter = hist(torch.where(p == t, t, num_classes))
    return inter, area_p + area_t - inter, area_t


class AverageMeter:
    """Running average (reference: util/common_util.py:24-39)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
