"""The reference's training step: weighted cross-entropy with label
smoothing, gradient clipping by global norm, and AdamW with the
configuration's warm-up schedule, in float32 and plain PyTorch.

The loss is torch's CrossEntropyLoss(weight, label_smoothing) with its
weighted mean; class weights are the inverse square roots of the classes'
shares of the labels (absent classes floored at a share of 1e-12), as the
reference implementation computes them from its training set. AdamW is
written out (decoupled decay, bias-corrected moments, eps outside the
square root), one group over every parameter. The learning rate of update
t (t = 0 first) is base * gamma^(milestones passed) * the linear warm-up
factor 1 - (1 - t / warmup) * (1 - warmup_ratio).

It imports nothing of the program.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch
from torch.nn import functional as F


def class_weights(labels_list, num_classes: int) -> torch.Tensor:
    counts = np.zeros(num_classes, np.float64)
    for lab in labels_list:
        lab = np.asarray(lab)
        counts += np.bincount(lab[lab >= 0], minlength=num_classes)[:num_classes]
    share = counts / counts.sum()
    return torch.tensor(1.0 / np.sqrt(np.maximum(share, 1e-12)), dtype=torch.float32)


def loss_fn(logits, labels, weights, smoothing: float):
    """The weighted, smoothed cross-entropy over every row."""
    return F.cross_entropy(logits, labels, weight=weights.to(logits.device),
                           label_smoothing=smoothing)


def learning_rate(cfg, t: int, iter_per_epoch: int) -> float:
    ms = sorted(int(m * iter_per_epoch) for m in (cfg.get("milestones") or []))
    warm = cfg["warmup_epochs"] * iter_per_epoch
    factor = cfg["gamma"] ** bisect.bisect_right(ms, t)
    w = 1.0 if t > warm else 1.0 - (1.0 - t / max(warm, 1)) * (1.0 - cfg["warmup_ratio"])
    return cfg["learning_rate"] * factor * w


class AdamW:
    def __init__(self, params, weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.wd, (self.b1, self.b2), self.eps = weight_decay, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads, lr: float):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(m / c1, (v / c2).sqrt() + self.eps, value=-lr)


def clip(grads, max_norm: float):
    """The gradients scaled by max_norm / |g| where the global norm |g| is at
    least max_norm."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    coef = 1.0 if float(norm) < max_norm else max_norm / float(norm)
    return [g * coef for g in grads]


def train_step(model, scene_set, weights, cfg, opt: AdamW, lr: float, prec):
    """One step: forward in training mode, loss, backward, clip, AdamW.
    Returns (loss, the clipped gradients as the optimizer got them, the
    gradients before the clip, the logits)."""
    model.train()
    for p in model.parameters():
        p.grad = None
    logits = model(scene_set, prec)
    loss = loss_fn(logits, scene_set["labels"], weights,
                   float(cfg.get("label_smoothing") or 0.0))
    loss.backward()
    grads = clip([p.grad for p in model.parameters()], float(cfg.get("grad_clip_norm", 10.0)))
    opt.step(grads, lr)
    return loss.detach(), grads, [p.grad for p in model.parameters()], logits.detach()
