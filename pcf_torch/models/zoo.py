"""Model zoo: PCF_Tiny / Small / Normal / Large backbone constructors, as
pcf_tpu/models/zoo.py builds them (the reference's
model_architecture.py:248-342). The variants differ in num_heads, residual
blocks per level, WeightNet mid_dim, levels, and grid-size multipliers. Each
returns (PCF_Backbone(cfg), cfg).
"""

from __future__ import annotations

from pcf_torch.config import Config, get_default_configs
from pcf_torch.models.backbone import PCF_Backbone


def _backbone(input_grid_size: float, base_dim: int, num_level: int, num_heads: int,
              resblocks, mid_dim: int, grid_multipliers):
    cfg = get_default_configs(Config(), num_level=num_level, base_dim=base_dim)
    cfg.guided_level = 0
    cfg.num_heads = num_heads
    cfg.resblocks = list(resblocks)
    cfg.mid_dim = [mid_dim] * num_level
    cfg.grid_size = [input_grid_size * m for m in grid_multipliers]
    return PCF_Backbone(cfg), cfg


def PCF_Tiny(input_grid_size: float, base_dim: int = 64):
    return _backbone(input_grid_size, base_dim, 5, 1, [0, 1, 1, 1, 1], 4,
                     (1, 2, 4, 8, 16))


def PCF_Small(input_grid_size: float, base_dim: int = 64):
    return _backbone(input_grid_size, base_dim, 5, 8, [0, 2, 2, 2, 2], 4,
                     (1, 2, 4, 8, 16))


def PCF_Normal(input_grid_size: float, base_dim: int = 64):
    return _backbone(input_grid_size, base_dim, 5, 8, [0, 2, 4, 6, 6], 16,
                     (1, 2, 4, 8, 16))


def PCF_Large(input_grid_size: float, base_dim: int = 64):
    return _backbone(input_grid_size, base_dim, 6, 8, [0, 2, 4, 6, 6, 2], 16,
                     (1, 2.5, 5, 10, 20, 40))
