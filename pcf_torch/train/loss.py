"""Segmentation loss: weighted cross-entropy with label smoothing + ignore.

pcf_tpu/train/loss.py's semantics, which are torch's
nn.CrossEntropyLoss(weight, ignore_index, label_smoothing) with the
'weighted mean' reduction: each point's loss is scaled by its target class's
weight and the sum is divided by the summed weights. Padded rows are left
out through the validity mask as well as through ignore_label.

Under spatial sharding (parallel/spatial.py) each rank holds a shard of the
points, and pcf_tpu's `axis_name` sums (total_w, num, n_valid) over the
shards before dividing (:58-61). Here `group` does that with one all_reduce,
outside autograd: the loss's value is the global one on every rank, and its
gradient on each rank is that of local_num / global_total_w, so the
gradients summed over the ranks (the spatial step's all_reduce) are the
unsharded loss's. total_w depends on the labels alone and takes no
gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.nn import functional as F


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None,
                       class_weights: torch.Tensor | None = None,
                       label_smoothing: float = 0.0, ignore_label: int = -100,
                       group=None):
    """logits [N, C], labels [N] int, mask [N] bool -> (scalar loss, number
    of valid points). Safe when every point is ignored (loss 0). With
    `group` (a process group) the sums are taken over its ranks' rows (see
    the module)."""
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
    total_w, num, n_valid = wy.sum(), per.sum(), valid.sum()
    if group is not None:
        # f64: the counts stay exact, and one rank's sums come back unchanged
        sums = torch.stack([t.detach().double() for t in (total_w, num, n_valid)])
        dist.all_reduce(sums, group=group)
        total_w = sums[0].to(total_w.dtype)
        num = num + (sums[1].to(num.dtype) - num.detach())
        n_valid = sums[2].to(n_valid.dtype)
    return num / total_w.clamp_min(1e-8), n_valid
