"""Multi-head guidance (pcf_tpu/nn/guidance.py), the attention that
modulates the PointConv weights; the gating is per neighbour, not a
softmax. Two variants:
  * MultiHeadGuidance: subtractive attention, scores = sigmoid(MLP(q - k)),
    MLP [C -> 8 -> num_heads] with ReLU between the layers;
  * MultiHeadGuidanceQK (cfg.attention_type != "subtraction"): scaled dot
    product per head of q with the centre's (first neighbour's) key, through
    one qk_linear LinearBN applied to q and then to k, sigmoid.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from pcf_torch.nn.norm import LinearBN


class MultiHeadGuidance(nn.Module):
    def __init__(self, in_dim: int, num_heads: int, layer_norm_guidance: bool = False,
                 use_bn: bool = True, dtype=None):
        super().__init__()
        if layer_norm_guidance:
            # flax LayerNorm's epsilon
            self.layer_norm_q = nn.LayerNorm(in_dim, eps=1e-6)
            self.layer_norm_k = nn.LayerNorm(in_dim, eps=1e-6)
        self.layer_norm_guidance = layer_norm_guidance
        self.mlp_0 = LinearBN(in_dim, 8, use_bn=use_bn, dtype=dtype)
        self.mlp_1 = LinearBN(8, num_heads, use_bn=use_bn, dtype=dtype)

    def forward(self, guidance_query, guidance_key, mask=None) -> torch.Tensor:
        if self.layer_norm_guidance:
            guidance_query = self.layer_norm_q(guidance_query)
            guidance_key = self.layer_norm_k(guidance_key)
        scores = F.relu(self.mlp_0(guidance_query - guidance_key, mask))
        return torch.sigmoid(self.mlp_1(scores, mask))  # [M, K, num_heads]


class MultiHeadGuidanceQK(nn.Module):
    """sigmoid(<qk(q)[m, k, h], qk(k)[m, 0, h]> / sqrt(key_dim)) per head.
    The one qk_linear LinearBN runs on q, then on k: in training its BN
    running statistics move twice per forward, q first, as flax moves them
    when a module is called twice."""

    def __init__(self, in_dim: int, num_heads: int, num_hiddens: int, key_dim: int = 16,
                 use_bn: bool = True, dtype=None):
        super().__init__()
        if num_hiddens % num_heads:
            raise ValueError(f"num_hiddens {num_hiddens} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_heads, self.key_dim = num_heads, key_dim
        self.qk_linear = LinearBN(in_dim, key_dim * num_heads, use_bn=use_bn, dtype=dtype)

    def forward(self, q, k, mask=None) -> torch.Tensor:
        M, K, _ = q.shape
        q = self.qk_linear(q, mask).reshape(M, K, self.num_heads, self.key_dim)
        k = self.qk_linear(k, mask).reshape(M, K, self.num_heads, self.key_dim)
        attn = (q * k[:, :1]).sum(-1) * (self.key_dim ** -0.5)  # [M, K, H]
        return torch.sigmoid(attn)
