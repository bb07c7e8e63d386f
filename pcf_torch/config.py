"""Configuration for pcf_torch: the same YAML keys and defaults as
pcf_tpu/config.py, so every config in pcf_tpu/configs/ loads to an equal
dict here.

Two keys differ in meaning on the port, not in value:
  * `resolve_impl` named one of two TPU implementations of the same exact
    window selection. The port has one resolve (the window_resolve CUDA
    kernel) for both values, and rejects any other.
  * `fused_min_points` must be 0 (nn/fused.fused_wins): the TPU crossover
    thresholds were measured on another chip, and the port has none.

The shipped configurations are in pcf_torch/configs/, as JSON, one file per
YAML of pcf_tpu/configs/ with the same stem and the same keys and values.
The machine that runs the kernels has no PyYAML: a `.json` config loads
with json alone, and the `--set KEY=VALUE` overrides are parsed here
(parse_value) as yaml.safe_load would parse them. `yaml` is imported inside
`load_config` only, for a YAML file.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
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


CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


def load_config(path: str, overrides=None) -> Config:
    """Load a JSON config (pcf_torch/configs/*.json, the shipped ones) or a
    YAML one, and fill model+training defaults; `overrides` is an optional
    list of "key=value" strings (apply_overrides). A `.json` file is read with
    json alone. A YAML file needs PyYAML: without it the error names the
    port's JSON copy of the same stem, where there is one; no other file is
    read in its place."""
    if path.endswith(".json"):
        with open(path, "r") as f:
            cfg = Config.from_dict(json.load(f))
    else:
        try:
            import yaml
        except ImportError as e:
            stem = os.path.splitext(os.path.basename(path))[0]
            copy_ = os.path.join(CONFIG_DIR, f"{stem}.json")
            hint = (f"its JSON copy is {copy_}" if os.path.exists(copy_)
                    else f"pass a .json config ({CONFIG_DIR} holds the "
                    "shipped ones)")
            raise ModuleNotFoundError(
                f"{path} is YAML and PyYAML is not installed: {hint}", name="yaml") from e
        with open(path, "r") as f:
            cfg = Config.from_dict(yaml.safe_load(f))
    cfg = get_default_configs(cfg, cfg.get("num_level", 5), cfg.get("base_dim", 64))
    cfg = get_default_training_cfgs(cfg)
    cfg.config = path
    return apply_overrides(cfg, overrides)


def apply_overrides(cfg: Config, overrides) -> Config:
    """Apply "key=value" strings onto cfg, each value parsed by
    parse_value. Dotted keys assign into nested Configs, creating them as
    needed; assigning through a non-mapping raises."""
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
        try:
            node[parts[-1]] = parse_value(raw)
        except ValueError as e:
            raise ValueError(f"override {kv!r}: {e}") from None
    return cfg


# YAML 1.1's implicit types of a plain scalar (PyYAML's SafeLoader resolver)
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                         False)}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
                  r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
_TIMESTAMP = re.compile(r"[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
                        r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+)"
                        r"[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
                        r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?")
# where a plain scalar may not start: YAML's indicators
_INDICATORS = "!&*|>%@`#'\"[]{},?:-"


def _sexagesimal(sign: int, text: str, num):
    value = 0
    for part in text.split(":"):
        value = value * 60 + num(part)
    return sign * value


def _plain(text: str):
    """A plain scalar's value, as YAML 1.1 resolves it (PyYAML's safe
    constructors); ValueError where it would be a YAML type that JSON and
    Python's config values do not have (a timestamp, the merge key)."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if ":" in v:
            return _sexagesimal(sign, v, int)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.fullmatch(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return _sexagesimal(sign, v, float)
        return sign * float(v)
    if _TIMESTAMP.fullmatch(text) or text in ("<<", "="):
        raise ValueError(f"{text!r} is a YAML timestamp or merge key, not a config value")
    return text


class _Flow:
    """A YAML flow scalar or collection on one line: [a, 1], {k: v},
    quoted strings, plain scalars. Raises ValueError on what it does not
    read as YAML would (anchors, tags, aliases, comments, block syntax)."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def error(self, what: str):
        raise ValueError(f"cannot read {self.s!r} without PyYAML: {what} at column {self.i}")

    def skip(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self, flow: bool):
        self.skip()
        if self.i >= len(self.s):
            return None
        c = self.s[self.i]
        if c == "[":
            return self.sequence()
        if c == "{":
            return self.mapping()
        if c == "'":
            return self.single()
        if c == '"':
            return self.double()
        if c in _INDICATORS and not (c in "-?:" and self.i + 1 < len(self.s)
                                     and self.s[self.i + 1] not in " \t,[]{}"):
            self.error(f"the indicator {c!r}")
        return self.plain(flow)

    def plain(self, flow: bool):
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            nxt = self.s[self.i + 1] if self.i + 1 < len(self.s) else " "
            if flow and c in ",[]{}":
                break
            if c == ":" and (nxt in " \t" or (flow and nxt in ",[]{}")):
                if not flow:
                    self.error("a mapping")
                break
            if c == "#" and self.s[self.i - 1] in " \t":
                self.error("a comment")
            if c in "\n\r":
                self.error("a line break")
            self.i += 1
        return _plain(self.s[start:self.i].rstrip(" \t"))

    def single(self):
        out, self.i = [], self.i + 1
        while True:
            j = self.s.find("'", self.i)
            if j < 0:
                self.error("an unterminated quote")
            out.append(self.s[self.i:j])
            if self.s[j + 1:j + 2] == "'":
                out.append("'")
                self.i = j + 2
            else:
                self.i = j + 1
                return "".join(out)

    def double(self):
        m = re.compile(r'"(?:[^"\\\n]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})*"').match(self.s, self.i)
        if m is None:
            self.error("a double-quoted string with YAML-only escapes")
        self.i = m.end()
        return json.loads(m.group(0))

    def items(self, close: str, item):
        self.i += 1
        out = []
        while True:
            self.skip()
            if self.i >= len(self.s):
                self.error(f"an unclosed {close!r}")
            if self.s[self.i] == close:
                self.i += 1
                return out
            out.append(item())
            self.skip()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i:self.i + 1] != close:
                self.error(f"{self.s[self.i:self.i + 1]!r} where ',' or {close!r} belongs")

    def sequence(self):
        def item():
            v = self.value(True)
            self.skip()
            if self.s[self.i:self.i + 1] == ":":
                self.error("a mapping inside a sequence")
            return v
        return self.items("]", item)

    def mapping(self):
        def item():
            k = self.value(True)
            self.skip()
            if self.s[self.i:self.i + 1] != ":":
                self.error("a mapping key without a value")
            self.i += 1
            self.skip()
            v = self.value(True) if self.s[self.i:self.i + 1] not in (",", "}") else None
            if isinstance(k, (list, dict)):
                self.error("a collection as a mapping key")
            return k, v
        pairs = self.items("}", item)
        out = dict(pairs)
        if len(out) != len(pairs):
            self.error("a repeated mapping key")
        return out


def parse_value(raw: str):
    """The value of an override's "key=value" text as `yaml.safe_load(raw)`
    gives it, without PyYAML (the card's machine has none): JSON's values,
    and the YAML 1.1 scalars JSON lacks (True/yes/on, ~, bare strings,
    octal, hex, 1_000, .inf). YAML 1.1's own rules hold where the two
    differ: 1e-4 is the string "1e-4", 1.0e-4 a float. Where a value would
    need more of YAML (anchors, tags, block syntax, timestamps), ValueError
    rather than a guess."""
    p = _Flow(raw.strip())
    out = p.value(False)
    p.skip()
    if p.i != len(p.s):
        p.error("text after the value")
    return out
