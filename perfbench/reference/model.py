"""Plain PyTorch reference of PointConvFormer segmentation (PCF_Normal
layout), the model the benchmark holds the program against.

It follows the published PointConvFormer (Wu et al., CVPR 2023) as the
reference implementation lays it out: a first VI-PointConv and two
PointConv residual blocks at level 0, then per level a strided PCF layer
(guidance-modulated PointConv) and its PCF residual blocks, a decoder of
transposed PointConvs with encoder skips, and a two-layer head. It is
written for one scene set at a time with no padding: every row is a real
point, so BatchNorm statistics are plain means over rows (and over the K
neighbours where the input is [M, K, C]). Module and parameter names are
those of the program's model, so that one set of weights can be handed to
both; the program's fused layers store their output linear transposed
(perfbench/weights.py maps the two).

Only the keys of the benchmark's configurations are implemented:
USE_VI, USE_PE, USE_XYZ, use_level_1, attention_type "subtraction",
layer_norm_guidance off, transformer_type "PCF", guided_level 0, BatchNorm
on, no dropout or DropPath. `Precision` rounds the operands of every
matrix product, for the lower-precision control (perfbench/check.py).

It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F


class Precision:
    """How values are held where the program holds them in its compute
    dtype: the operands and outputs of every linear, every BatchNorm's
    output, the contractions' operands. "f32" leaves them; "fp8" rounds each
    to float8 e4m3 with a per-tensor scale (amax at 448), as an fp8 path
    would hold them; the backward of the rounding passes the gradient
    through. TF32 is torch's own switch
    (torch.backends.cuda.matmul.allow_tf32), set by the caller."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32" or x.device.type == "meta":
            return x
        with torch.no_grad():
            scale = 448.0 / x.abs().amax().clamp_min(1e-30)
            step = (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale - x
        # the rounded value forward, the gradient passed through unrounded
        return x + step


F32 = Precision("f32")


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out))

    def forward(self, x, prec):
        return prec(F.linear(prec(x), prec(self.weight), self.bias))


class BatchNorm(nn.Module):
    """BatchNorm over every row (and neighbour) of the input; running
    statistics move by `momentum` with the unbiased variance."""

    def __init__(self, c: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        if self.training:
            rows = x.reshape(-1, x.shape[-1])
            mean = rows.mean(0)
            var = (rows - mean).pow(2).mean(0)
            with torch.no_grad():
                n = rows.shape[0]
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * var * n / max(n - 1, 1))
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class LinearBN(nn.Module):
    def __init__(self, d_in: int, d_out: int, momentum: float = 0.1):
        super().__init__()
        self.c = Dense(d_in, d_out)
        self.bn = BatchNorm(d_out, momentum)

    def forward(self, x, prec):
        return prec(self.bn(self.c(x, prec)))


class UnaryBlock(nn.Module):
    def __init__(self, d_in: int, d_out: int, no_relu: bool = False):
        super().__init__()
        self.mlp = LinearBN(d_in, d_out)
        self.no_relu = no_relu

    def forward(self, x, prec):
        x = self.mlp(x, prec)
        return x if self.no_relu else F.leaky_relu(x, 0.1)


class _Core(nn.Module):
    def __init__(self, d_in: int, dims, momentum: float):
        super().__init__()
        self.n = len(dims)
        for i, d in enumerate(dims):
            self.add_module(f"mlp_convs_{i}", LinearBN(d_in, d, momentum))
            d_in = d

    def forward(self, x, prec):
        for i in range(self.n):
            x = F.relu(getattr(self, f"mlp_convs_{i}")(x, prec))
        return x


class WeightNet(nn.Module):
    """MLP of LinearBN + ReLU over per-neighbour coordinates. Its BatchNorm
    momentum is 1 - 0.9^2: the reference implementation checkpoints it and
    its forward runs twice a step, moving the statistics twice."""

    def __init__(self, d_in: int, d_out: int, hidden=(8, 8)):
        super().__init__()
        self.core = _Core(d_in, list(hidden) + [d_out], 1.0 - 0.9 ** 2)

    def forward(self, x, prec):
        return self.core(x, prec)


class Guidance(nn.Module):
    """Subtractive multi-head guidance: sigmoid(MLP(q - k)) per head."""

    def __init__(self, d_in: int, heads: int):
        super().__init__()
        self.mlp_0 = LinearBN(d_in, 8)
        self.mlp_1 = LinearBN(8, heads)

    def forward(self, q, k, prec):
        return torch.sigmoid(self.mlp_1(F.relu(self.mlp_0(q - k, prec)), prec))


def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def vi_features(localized, nbr_norm, ctr_norm):
    """The viewpoint-invariant features of VI-PointConv (X. Li et al., WACV
    2023): nine rotation-invariant scalars of the offset and the two
    normals, then the offset itself; [M, K, 12]."""
    n_s = ctr_norm[:, None, :]
    r = _unit(localized)
    ns_r = (n_s * r).sum(-1, keepdim=True)
    v = _unit(n_s - ns_r * r)
    w = _unit(torch.linalg.cross(r, v, dim=-1))
    t = [(nbr_norm * n_s).sum(-1), ns_r[..., 0], (r * nbr_norm).sum(-1),
         (localized * n_s).sum(-1), (nbr_norm * r).sum(-1), (nbr_norm * v).sum(-1),
         (nbr_norm * w).sum(-1),
         (localized * torch.linalg.cross(nbr_norm, n_s.expand_as(nbr_norm), dim=-1)).sum(-1),
         torch.linalg.vector_norm(localized, dim=-1)]
    return torch.cat([torch.stack(t, -1), localized], -1)


def pconv(gathered, weights, prec):
    """sum_k gathered[m, k, c] * weights[m, k, w] -> [M, C*W], c-major."""
    M, _, C = gathered.shape
    return torch.einsum("mkc,mkw->mcw", prec(gathered), prec(weights)).reshape(
        M, C * weights.shape[-1])


def guided(gathered, score):
    """Channel c of the gathered features scaled by guidance head c % H."""
    M, K, C = gathered.shape
    H = score.shape[-1]
    return (gathered.reshape(M, K, C // H, H) * score[:, :, None, :]).reshape(M, K, C)


def geometry(xyz_src, norm_src, nei, xyz_ctr, norm_ctr):
    """(offsets [M, K, 3], VI features [M, K, 12]) of edges `nei` [M, K]
    from centres (xyz_ctr, norm_ctr) into the source rows."""
    loc = xyz_src[nei] - xyz_ctr[:, None, :]
    return loc, vi_features(loc, norm_src[nei], norm_ctr)


class PointConv(nn.Module):
    """The first VI-PointConv: no bottleneck, VI features as PE."""

    def __init__(self, d_in, d_out, mid):
        super().__init__()
        self.weightnet = WeightNet(12, mid)
        self.linear = LinearBN((d_in + 12) * mid, d_out)

    def forward(self, feats, nei, loc, vi, prec):
        w = self.weightnet(vi, prec)
        g = torch.cat([feats[nei], vi], -1)
        return F.relu(self.linear(pconv(g, w, prec), prec))


class PointConvStridePE(nn.Module):
    """Bottleneck PointConv with positional encoding and a shortcut (here
    only the same-level residual block)."""

    def __init__(self, c, mid):
        super().__init__()
        c4, last = c // 4, min(c // 4, 32)
        self.unary1 = UnaryBlock(c, c4)
        self.pe_convs = WeightNet(3, last, hidden=(c4,))
        self.weightnet = WeightNet(12, mid)
        self.linear = LinearBN((c4 + last) * mid, c // 2)
        self.unary2 = UnaryBlock(c // 2, c, no_relu=True)

    def forward(self, feats, nei, loc, vi, prec):
        fx = self.unary1(feats, prec)
        pe = self.pe_convs(loc, prec)
        w = self.weightnet(vi, prec)
        new = F.relu(self.linear(pconv(torch.cat([fx[nei], pe], -1), w, prec), prec))
        return F.leaky_relu(self.unary2(new, prec) + feats, 0.1)


class PCFLayer(nn.Module):
    """PointConvFormer layer: PointConv weights modulated by guidance from
    feature differences; strided (max-pooled key and shortcut) or
    same-level (the centre as key)."""

    def __init__(self, d_in, d_out, mid, heads):
        super().__init__()
        c4 = d_out // 4
        self.d_in, self.d_out = d_in, d_out
        self.unary1 = UnaryBlock(d_in, c4)
        self.guidance_unary = UnaryBlock(c4, 32, no_relu=True)
        self.mlp_conv = LinearBN(12, 32)
        self.guidance_weight = Guidance(64, heads)
        self.weightnet = WeightNet(12, mid)
        self.linear = LinearBN(c4 * mid, d_out // 2)
        self.unary2 = UnaryBlock(d_out // 2, d_out, no_relu=True)
        if d_in != d_out:
            self.unary_shortcut = UnaryBlock(d_in, d_out, no_relu=True)

    def forward(self, feats, nei, loc, vi, prec, strided):
        fx = self.unary1(feats, prec)
        gx = self.guidance_unary(fx, prec)
        pe = F.relu(self.mlp_conv(vi, prec))
        q = torch.cat([gx[nei], pe], -1)
        key = q.amax(1, keepdim=True) if strided else q[:, :1]
        score = self.guidance_weight(q, key.expand_as(q), prec)
        w = self.weightnet(vi, prec)
        new = F.relu(self.linear(pconv(guided(fx[nei], score), w, prec), prec))
        new = self.unary2(new, prec)
        short = feats[nei].amax(1) if strided else feats
        if self.d_in != self.d_out:
            short = self.unary_shortcut(short, prec)
        return F.leaky_relu(new + short, 0.1)


class ResBlocks(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class PointConvTransposePE(nn.Module):
    """Decoder: features of level l+1 onto level l (propagate edges), the
    encoder skip added, then one LinearBN + ReLU."""

    def __init__(self, d_in, d_out, mid):
        super().__init__()
        pe = min(d_out // 4, 32)
        self.pe_convs = WeightNet(3, pe, hidden=(d_out // 4,))
        self.weightnet = WeightNet(12, mid)
        self.linear = LinearBN((d_in + pe) * mid, d_out)
        self.mlp2_convs_0 = LinearBN(d_out, d_out)

    def forward(self, sparse_feats, nei, loc, vi, skip, prec):
        pe = self.pe_convs(loc, prec)
        w = self.weightnet(vi, prec)
        new = F.relu(self.linear(pconv(torch.cat([sparse_feats[nei], pe], -1), w, prec), prec))
        return F.relu(self.mlp2_convs_0(new + skip, prec))


class Backbone(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        L, fd, mid = cfg["num_level"], cfg["feat_dim"], cfg["mid_dim"]
        self.L = L
        self.selfpointconv = PointConv(6, cfg["base_dim"], mid[0])
        self.selfpointconv_res = ResBlocks(
            [PointConvStridePE(cfg["base_dim"], mid[0]) for _ in range(2)])
        self.resblocks = cfg["resblocks"]
        for i in range(1, L):
            self.add_module(f"pointconv_{i - 1}",
                            PCFLayer(fd[i - 1], fd[i], mid[i], cfg["num_heads"]))
            if self.resblocks[i]:
                self.add_module(f"pointconv_res_{i - 1}", ResBlocks(
                    [PCFLayer(fd[i], fd[i], mid[i], cfg["num_heads"])
                     for _ in range(self.resblocks[i])]))


class Segmentation(nn.Module):
    """forward(scene set) -> logits [N0, classes], the scene set being the
    dict of perfbench/reference/pyramid.py: per level points, normals and
    the three edge sets, rows of every scene concatenated."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        L = cfg["num_level"]
        self.pcf_backbone = Backbone(cfg)
        for idx, i in enumerate(range(L - 2, -1, -1)):
            d_out = cfg["base_dim"] if i == 0 else cfg["feat_dim"][i]
            self.add_module(f"pointdeconv_{idx}", PointConvTransposePE(
                cfg["feat_dim"][i + 1], d_out, cfg.get("mid_dim_back", 1)))
        self.fc1 = LinearBN(cfg["base_dim"], cfg["base_dim"])
        self.fc2 = Dense(cfg["base_dim"], cfg["num_classes"])

    def forward(self, s, prec: Precision = F32):
        bb, L = self.pcf_backbone, self.cfg["num_level"]
        pts, nrm = s["points"], s["norms"]
        es, ef, ep = s["edges_self"], s["edges_forward"], s["edges_propagate"]
        loc, vi = geometry(pts[0], nrm[0], es[0], pts[0], nrm[0])
        feat = bb.selfpointconv(torch.cat([s["feats"], pts[0]], -1), es[0], loc, vi, prec)
        for blk in bb.selfpointconv_res.blocks:
            feat = blk(feat, es[0], loc, vi, prec)
        feats = [feat]
        for i in range(1, L):
            loc, vi = geometry(pts[i - 1], nrm[i - 1], ef[i - 1], pts[i], nrm[i])
            feat = getattr(bb, f"pointconv_{i - 1}")(feat, ef[i - 1], loc, vi, prec, True)
            if bb.resblocks[i]:
                loc, vi = geometry(pts[i], nrm[i], es[i], pts[i], nrm[i])
                for blk in getattr(bb, f"pointconv_res_{i - 1}").blocks:
                    feat = blk(feat, es[i], loc, vi, prec, False)
            feats.append(feat)
        for idx, i in enumerate(range(L - 2, -1, -1)):
            loc, vi = geometry(pts[i + 1], nrm[i + 1], ep[i], pts[i], nrm[i])
            feat = getattr(self, f"pointdeconv_{idx}")(feat, ep[i], loc, vi, feats[i], prec)
        return self.fc2(F.relu(self.fc1(feat, prec)), prec)


def init_bounds(model: nn.Module) -> dict:
    """{parameter name: (low, high)} of the uniform draw each parameter
    takes: a Dense's weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (torch's nn.Linear default), a BatchNorm's weight 1 + U(-0.1, 0.1) and
    bias U(-0.1, 0.1)."""
    out = {}
    for mname, m in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, Dense):
            b = 1.0 / math.sqrt(m.weight.shape[1])
            out[pre + "weight"] = (-b, b)
            out[pre + "bias"] = (-b, b)
        elif isinstance(m, BatchNorm):
            out[pre + "weight"] = (0.9, 1.1)
            out[pre + "bias"] = (-0.1, 0.1)
    return out
