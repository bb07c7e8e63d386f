"""Normalisation blocks with padding-mask support.

A packed batch is padded to static shapes, so batch statistics must leave
the padded rows out; torch.nn.BatchNorm1d cannot. MaskedBatchNorm follows
pcf_tpu/nn/norm.py exactly:
  * masked single-pass statistics E[x^2] - E[x]^2 in f32 (f64 for an f64
    input), clamped at 0,
    over every axis but the last;
  * in training, running = (1 - m) * running + m * batch with the unbiased
    batch variance (momentum 0.1, torch's convention); normalisation uses
    the biased variance; eps 1e-5;
  * in eval, the running statistics.
The output keeps the input's dtype. Training mode is the module's
`training` flag; inside `frozen_running_stats()` training leaves the running
statistics as they are (the recompute of a rematerialised block,
nn/resstack.py).

With `flat_k` = K (pcf_tpu's flat-lane mode, cfg.flat_geom) the input is
k-major flat [M, K*c]: statistics stay per channel, pooled over K, and the
parameters are those of the 3-D form. pcf_tpu applies a block-diagonal
kron(I_K, W) to the lanes; here the same arithmetic runs on the [M, K, c]
view.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager

import torch
from torch import nn
from torch.nn import functional as F

from pcf_torch.nn.init import Dense


_FROZEN = contextvars.ContextVar("frozen_running_stats", default=False)


@contextmanager
def frozen_running_stats():
    """MaskedBatchNorm in training moves no running statistic inside this
    context (in this thread: autograd runs a recompute in its own)."""
    token = _FROZEN.set(True)
    try:
        yield
    finally:
        _FROZEN.reset(token)


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5,
                 weight_init: float = 1.0):
        super().__init__()
        self.features = features
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.full((features,), float(weight_init)))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                flat_k: int = 0) -> torch.Tensor:
        if flat_k:
            return self(x.reshape(*x.shape[:-1], flat_k, self.features), mask).reshape(x.shape)
        acc = torch.promote_types(x.dtype, torch.float32)
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            xf = x.to(acc).reshape(-1, self.features)
            if mask is None:
                cnt = torch.full((), float(xf.shape[0]), device=x.device)  # no host copy: capturable
                s, s2 = xf.sum(0), (xf * xf).sum(0)
            else:
                m = mask.to(acc).reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
                m = m.expand(x.shape[:-1] + (1,)).reshape(-1, 1)
                cnt = m.sum()
                s, s2 = (xf * m).sum(0), (xf * xf * m).sum(0)
            cnt = cnt.clamp_min(1.0)
            mean = s / cnt
            var = (s2 / cnt - mean * mean).clamp_min(0.0)
            if not _FROZEN.get():
                with torch.no_grad():
                    unbiased = var * cnt / (cnt - 1.0).clamp_min(1.0)
                    self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                    self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        y = (x.to(acc) - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)


class LinearBN(nn.Module):
    """Dense + MaskedBatchNorm over every non-feature axis."""

    def __init__(self, in_dim: int, out_dim: int, use_bn: bool = True,
                 bn_weight_init: float = 1.0, bn_momentum: float = 0.1, dtype=None):
        super().__init__()
        self.c = Dense(in_dim, out_dim, dtype=dtype)
        self.bn = (MaskedBatchNorm(out_dim, momentum=bn_momentum,
                                   weight_init=bn_weight_init) if use_bn else None)

    def forward(self, x, mask=None, flat_k: int = 0):
        if flat_k:
            y = self(x.reshape(*x.shape[:-1], flat_k, -1), mask)
            return y.reshape(*x.shape[:-1], -1)
        x = self.c(x)
        return x if self.bn is None else self.bn(x, mask)


class UnaryBlock(nn.Module):
    """Linear(+BN) + LeakyReLU(0.1)."""

    def __init__(self, in_dim: int, out_dim: int, use_bn: bool = True,
                 bn_momentum: float = 0.1, no_relu: bool = False, dtype=None):
        super().__init__()
        self.mlp = LinearBN(in_dim, out_dim, use_bn=use_bn,
                            bn_momentum=bn_momentum, dtype=dtype)
        self.no_relu = no_relu

    def forward(self, x, mask=None):
        x = self.mlp(x, mask)
        return x if self.no_relu else F.leaky_relu(x, 0.1)
