"""WeightNet: the MLP that turns per-neighbour (VI-)relative coordinates
[M, K, in_ch] into per-neighbour convolution weights [M, K, out_channel].
LinearBN + ReLU after every layer, the last one included. With `flat_k` = K
the input and output are k-major flat, [M, K*in_ch] -> [M, K*out_channel]
(nn/norm.py).
"""

from __future__ import annotations

from typing import Sequence

from torch import nn
from torch.nn import functional as F

from pcf_torch.nn.norm import LinearBN


class _WeightNetCore(nn.Module):
    def __init__(self, in_channel: int, dims: Sequence[int], use_bn: bool,
                 bn_momentum: float, dtype):
        super().__init__()
        self.n = len(dims)
        for i, d in enumerate(dims):
            self.add_module(f"mlp_convs_{i}", LinearBN(
                in_channel, d, use_bn=use_bn, bn_momentum=bn_momentum, dtype=dtype))
            in_channel = d

    def forward(self, x, mask=None, flat_k: int = 0):
        for i in range(self.n):
            x = F.relu(getattr(self, f"mlp_convs_{i}")(x, mask, flat_k))
        return x


class WeightNet(nn.Module):
    """`efficient=True` is pcf_tpu's rematerialised WeightNet. pcf_tpu gives
    its BatchNorms the momentum 1 - (1 - 0.1)^2 = 0.19, the single update
    equal to the reference's two updates per step (its checkpointed forward
    runs twice); the port keeps that momentum. The forward is not
    recomputed here: that belongs with the backward."""

    def __init__(self, in_channel: int, out_channel: int,
                 hidden_unit: Sequence[int] = (8, 8), efficient: bool = False,
                 use_bn: bool = True, dtype=None):
        super().__init__()
        m = 0.1
        bn_momentum = 1.0 - (1.0 - m) ** 2 if efficient else m
        self.core = _WeightNetCore(in_channel, list(hidden_unit or ()) + [out_channel],
                                   use_bn, bn_momentum, dtype)

    def forward(self, localized_xyz, mask=None, flat_k: int = 0):
        return self.core(localized_xyz, mask, flat_k)
