"""A stack of identical same-resolution residual blocks.

pcf_tpu scans one compiled block body over parameters stacked on axis 0
(flax nn.scan); here the blocks are separate modules run in a plain loop,
`blocks.{j}` holding what pcf_tpu stores at index j of `blocks/block`. The
stage geometry (localized offsets, VI features) depends only on the edges,
so it is computed once outside and shared by every block.

With cfg.remat_blocks (the default) each block is recomputed in the
backward instead of keeping its intermediates (pcf_tpu's nn.remat), with
torch.utils.checkpoint. flax's remat is functional and moves the BatchNorm
running statistics once per step; checkpoint runs the block's forward a
second time, so its recompute context leaves them alone and replays the
forward's random draws, the keep masks recorded as the forward drew them
(_recompute).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from pcf_torch.nn.layers import PCFLayer, kept_draws
from pcf_torch.nn.norm import frozen_running_stats


@contextmanager
def _recompute(draws: list):
    """checkpoint's recompute of a block in the backward: its dropout and
    DropPath masks are the ones its forward drew (`draws`), and the BN
    running statistics stay as they are."""
    with frozen_running_stats(), kept_draws(draws, replay=True):
        yield


def _features(block: nn.Module, *args, **kwargs):
    return block(*args, **kwargs)[0]


def _remat_contexts():
    """checkpoint's context_fn: the forward records the block's random draws
    and the recompute replays them. The generator's state is never read or
    set, which a CUDA graph capture would refuse."""
    draws = []
    return kept_draws(draws, replay=False), _recompute(draws)


class ResBlockStack(nn.Module):
    def __init__(self, block_cls, n_blocks: int, channels: int, cfg,
                 weightnet: Sequence[int], num_heads: int = 4):
        super().__init__()
        extra = (num_heads,) if block_cls is PCFLayer else ()
        self.remat = bool(cfg.get("remat_blocks"))
        self.blocks = nn.ModuleList(
            block_cls(channels, channels, cfg, tuple(weightnet), *extra)
            for _ in range(n_blocks))

    def forward(self, xyz, feats, nei_inds, norms, vi_features=None,
                localized_xyz=None, mask=None):
        for block in self.blocks:
            args = (xyz, feats, nei_inds, norms)
            kwargs = dict(vi_features=vi_features, localized_xyz=localized_xyz,
                          dense_mask=mask)
            if self.remat and torch.is_grad_enabled():
                # the port draws from no global random state, so checkpoint
                # need not stash it
                feats = checkpoint(_features, block, *args,
                                   use_reentrant=False, preserve_rng_state=False,
                                   context_fn=_remat_contexts,
                                   **kwargs)
            else:
                feats, _ = block(*args, **kwargs)
        return feats
