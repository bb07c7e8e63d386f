"""Configuration for pcf_torch: the same YAML keys and defaults as
pcf_tpu/config.py, so every config in pcf_tpu/configs/ loads to an equal
dict here.

Two keys differ in meaning on the port, not in value:
  * `resolve_impl` named one of two TPU implementations of the same exact
    window selection. The port has one resolve (the window_resolve CUDA
    kernel) for both values, and rejects any other.
  * `fused_min_points` must be 0 (nn/fused.fused_wins): the TPU crossover
    thresholds were measured on another chip, and the port has none.

`yaml` is imported inside `load_config` only, and not for a `.json` file
(JSON is YAML's subset): the machine that runs the kernels has no yaml, and
nothing else here needs it.
"""

from __future__ import annotations

import copy
import json
from typing import Any


class Config(dict):
    """A dict with attribute access."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    @classmethod
    def from_dict(cls, d) -> "Config":
        out = cls()
        for k, v in d.items():
            out[k] = cls.from_dict(v) if hasattr(v, "items") else v
        return out

    def copy(self) -> "Config":
        return Config.from_dict(copy.deepcopy(dict(self)))


def get_default_configs(cfg: Config, num_level: int = 5, base_dim: int = 64) -> Config:
    """Model-architecture defaults (keys and values of pcf_tpu.config)."""
    cfg.num_level = num_level
    cfg.base_dim = base_dim
    if "feat_dim" not in cfg:
        cfg.feat_dim = [base_dim * (i + 1) for i in range(cfg.num_level + 1)]
    cfg.setdefault("USE_VI", True)
    cfg.setdefault("USE_PE", False)
    cfg.setdefault("transformer_type", "PCF")
    cfg.setdefault("attention_type", "subtraction")
    cfg.setdefault("layer_norm_guidance", False)
    cfg.setdefault("drop_path_rate", 0.0)
    cfg.setdefault("BATCH_NORM", True)
    cfg.setdefault("dropout_rate", 0.0)
    cfg.setdefault("TIME", False)
    cfg.setdefault("USE_XYZ", True)
    cfg.setdefault("point_dim", 3)
    cfg.setdefault("mid_dim_back", 1)
    cfg.setdefault("use_level_1", True)
    cfg.setdefault("USE_CUDA_KERNEL", False)
    cfg.setdefault("PCONV_OPT", False)
    # selects the fused conv+linear kernels (nn/fused.py) over the unfused path
    cfg.setdefault("USE_PALLAS_KERNEL", bool(cfg.get("USE_CUDA_KERNEL", False)
                                             or cfg.get("PCONV_OPT", False)))
    cfg.setdefault("dropout_fc", 0.0)
    cfg.setdefault("num_classes", 20)
    cfg.setdefault("compute_dtype", "float32")
    cfg.setdefault("matmul_precision", "default")
    cfg.setdefault("scan_resblocks", True)
    cfg.setdefault("window_gather", False)
    cfg.setdefault("window_tile", 128)
    cfg.setdefault("window_size", None)
    cfg.setdefault("window_sizes", None)
    cfg.setdefault("window_margin", 1.3)
    cfg.setdefault("fused_eval", False)
    cfg.setdefault("flat_geom", False)
    cfg.setdefault("resolve_impl", "xla")
    cfg.setdefault("cm_geom", False)
    return cfg


def get_default_training_cfgs(cfg: Config) -> Config:
    """Training/augmentation defaults (keys and values of pcf_tpu.config)."""
    cfg.setdefault("label_smoothing", False)
    cfg.setdefault("accum_iter", 1)
    cfg.setdefault("rotate_aug", True)
    cfg.setdefault("flip_aug", False)
    cfg.setdefault("scale_aug", True)
    cfg.setdefault("transform_aug", False)
    cfg.setdefault("color_aug", True)
    cfg.setdefault("crop", False)
    cfg.setdefault("shuffle_index", True)
    cfg.setdefault("mix3D", False)
    cfg.setdefault("post_knn", False)
    cfg.setdefault("USE_WEIGHT", True)
    cfg.setdefault("ignore_label", -100)
    cfg.setdefault("optimizer", "AdamW")
    cfg.setdefault("learning_rate", 0.02)
    cfg.setdefault("adamw_decay", 0.05)
    cfg.setdefault("decay_rate", 0.0001)
    cfg.setdefault("gamma", 0.5)
    cfg.setdefault("scheduler", "MultiStepWithWarmup")
    cfg.setdefault("scheduler_update", "step")
    cfg.setdefault("warmup", "linear")
    cfg.setdefault("warmup_epochs", 10)
    cfg.setdefault("warmup_ratio", 1e-5)
    cfg.setdefault("milestones", None)
    cfg.setdefault("total_epoches", 300)
    cfg.setdefault("remat_blocks", True)
    cfg.setdefault("remat_layers", False)
    cfg.setdefault("remat_deconv", False)
    cfg.setdefault("grad_clip_norm", 10.0)
    cfg.setdefault("sync_bn", False)
    cfg.setdefault("manual_seed", 1)
    cfg.setdefault("BATCH_SIZE", 8)
    cfg.setdefault("NUM_WORKERS", 0)
    cfg.setdefault("MAX_POINTS_NUM", 550000)
    cfg.setdefault("print_freq", 5)
    cfg.setdefault("eval_freq", 5)
    cfg.setdefault("save_freq", 5)
    cfg.setdefault("use_tensorboard", False)
    cfg.setdefault("bucket_multiple", 8192)
    cfg.setdefault("data_parallel", None)
    return cfg


def load_config(path: str, overrides=None) -> Config:
    """Load a YAML (or, ending in .json, JSON) config and fill model+training
    defaults; `overrides` is an optional list of "key=value" strings (values
    parsed as YAML)."""
    with open(path, "r") as f:
        if path.endswith(".json"):
            cfg = Config.from_dict(json.load(f))
        else:
            import yaml

            cfg = Config.from_dict(yaml.safe_load(f))
    cfg = get_default_configs(cfg, cfg.get("num_level", 5), cfg.get("base_dim", 64))
    cfg = get_default_training_cfgs(cfg)
    cfg.config = path
    return apply_overrides(cfg, overrides)


def apply_overrides(cfg: Config, overrides) -> Config:
    """Apply "key=value" strings onto cfg. Dotted keys assign into nested
    Configs, creating them as needed; assigning through a non-mapping raises."""
    if overrides:
        import yaml
    for kv in overrides or []:
        key, _, raw = kv.partition("=")
        if not _:
            raise ValueError(f"override {kv!r} is not of the form key=value")
        parts = [p.strip() for p in key.strip().split(".")]
        node = cfg
        for p in parts[:-1]:
            child = node.get(p)
            if child is None:
                child = node[p] = Config()
            elif not isinstance(child, dict):
                raise ValueError(
                    f"override {kv!r}: {p!r} is a {type(child).__name__}, "
                    "not a nested config")
            node = child
        node[parts[-1]] = yaml.safe_load(raw)
    return cfg
