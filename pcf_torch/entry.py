"""Entry points: the flagship batch and model, on the card by default.

`flagship_batch` ports __graft_entry__._flagship: packed synthetic scenes at
the PCF_Normal grid (5 levels, 8 heads, resblocks [0,2,4,6,6], mid_dim 16,
USE_PE) with its config. `build` makes a model from a config with weights
drawn from a seeded generator, `build_training` that model with its
optimizer and the single-device train step, and `build_eval` that model with
the eval step. On the card both steps are captured once per bucket signature
as CUDA graphs and replayed (parallel/graphs.py). With device=None they use
"cuda" and raise when CUDA is absent; pass device="cpu" to run on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from pcf_torch import resolve_device
from pcf_torch.config import Config, get_default_configs, get_default_training_cfgs
from pcf_torch.core import pack_scenes
from pcf_torch.data import scene_to_item, synthetic_scene
from pcf_torch.models import PointConvFormer_Segmentation
from pcf_torch.nn.init import init_params
from pcf_torch.parallel.mesh import make_eval_step, make_train_step
from pcf_torch.train.state import create_train_state, make_optimizer


def flagship_batch(level0_points: int, bucket: int, num_levels: int = 5,
                   n_scenes: int = 2, base_dim: int = 64,
                   window_gather: bool = False, device=None, seed: int = 0,
                   level_caps=None):
    """(cfg, batch): the flagship config and a packed batch on `device`, of
    the scenes seeded seed, seed + 1, ...; `level_caps` packs them to the
    caps of another batch (the same signature, for a compiled step).

    Window sizes (self, forward, propagate) = (512, 1280, 384) are pinned to
    this synthetic workload's per-tile unique maxima plus margin."""
    device = resolve_device(device)
    grid = [0.1 * (2 ** i) for i in range(num_levels)]
    scenes = []
    for i in range(seed, seed + n_scenes):
        coord, norm, feats, labels = synthetic_scene(level0_points, extent=6.0, seed=i)
        scenes.append(scene_to_item(coord, norm, feats, labels, grid, 16, 16, 16,
                                    rng=np.random.default_rng(i),
                                    morton=window_gather))
    batch = pack_scenes(scenes, level_caps=level_caps, bucket_multiple=bucket,
                        window_tile=128 if window_gather else None,
                        window_sizes=(512, 1280, 384))
    cfg = get_default_configs(Config(), num_level=num_levels, base_dim=base_dim)
    cfg = get_default_training_cfgs(cfg)
    cfg.update(guided_level=0, num_heads=8,
               resblocks=[0, 2, 4, 6, 6, 2][:num_levels],
               mid_dim=[16] * num_levels, grid_size=grid, num_classes=20,
               USE_PE=True, scheduler="MultiStepWithWarmup", milestones=[100],
               warmup_epochs=1)
    return cfg, batch.to(device)


def build(cfg, device=None, seed: int = 0) -> PointConvFormer_Segmentation:
    """PointConvFormer_Segmentation(cfg) on `device`, in eval mode, its
    weights drawn on the CPU from torch.Generator().manual_seed(seed), so one
    seed gives the same weights on every device."""
    device = resolve_device(device)
    model = PointConvFormer_Segmentation(cfg)
    init_params(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def build_training(cfg, device=None, seed: int = 0):
    """(state, step): the model of `build` with cfg's optimizer in a
    TrainState (its schedule counting one step per epoch), and the
    single-device train step, step(state, batch, seed) -> (state, metrics),
    captured per bucket signature on the card."""
    tx, _ = make_optimizer(cfg)
    state = create_train_state(build(cfg, device, seed), tx)
    return state, make_train_step(cfg)


def build_eval(cfg, device=None, seed: int = 0):
    """(model, eval_step): the model of `build` and the eval step,
    eval_step(model, batch) -> logits."""
    return build(cfg, device, seed), make_eval_step(cfg)
