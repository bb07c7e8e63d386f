"""The port's own copy of the shipped configurations (pcf_torch/configs/*.json)
against pcf_tpu's YAML: the same keys and values, the same config after
defaults, loadable with PyYAML absent (as on the card's machine), the
`--set` overrides parsed as yaml.safe_load parses them, and a model built
from each JSON whose every parameter lands on a leaf of pcf_tpu's model from
the YAML."""

import glob
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pcf_tpu import config as j_config
from pcf_tpu.models import PointConvFormer_Segmentation as JModel

from pcf_torch import config as t_config
from pcf_torch.convert import _flatten, _target, _unstack
from pcf_torch.models import PointConvFormer_Segmentation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("pcf_10cm", "pcf_10cm_lite", "pcf_5cm", "pcf_pallas_10cm", "pcf_2cm_ptf2",
         "post_knn_10cm", "synth_demo", "synth_flagship")


def _yaml(name):
    return os.path.join(ROOT, "pcf_tpu", "configs", f"{name}.yaml")


def _json(name):
    return os.path.join(ROOT, "pcf_torch", "configs", f"{name}.json")


def test_one_json_for_every_shipped_yaml():
    stems = sorted(os.path.basename(p)[:-5] for p in glob.glob(_yaml("*")))
    assert stems == sorted(NAMES)
    assert sorted(os.path.basename(p)[:-5] for p in glob.glob(_json("*"))) == stems


@pytest.mark.parametrize("name", NAMES)
def test_json_equals_the_yaml(name):
    import json

    with open(_json(name)) as f, open(_yaml(name)) as g:
        got, want = json.load(f), yaml.safe_load(g)
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]


@pytest.mark.parametrize("name", NAMES)
def test_loaded_json_equals_pcf_tpu_loaded_yaml(name):
    got = t_config.load_config(_json(name))
    want = j_config.load_config(_yaml(name))
    assert got.pop("config") == _json(name)
    want.pop("config", None)
    assert dict(got) == dict(want)


@pytest.mark.parametrize("name", NAMES)
def test_json_loads_without_yaml(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = t_config.load_config(_json(name), ["total_epoches=1", "eval_freq=1"])
    assert cfg.total_epoches == 1 and cfg.eval_freq == 1 and cfg.num_level >= 4
    with pytest.raises(ModuleNotFoundError, match=rf"pcf_torch/configs/{name}\.json"):
        t_config.load_config(_yaml(name))


# values of `--set KEY=VALUE`, each parsed as yaml.safe_load parses it
AGREE = ["1", "-1", "+7", "0", "-0", "007", "08", "0x1F", "-0x1f", "0b101", "1_000", "1:30",
         "1:30.5", "1e-4", "1.0e-4", "1.0e4", "1E+5", "1.5", ".5", "-.5", "1.", "3.14e+2",
         "0.00001", "1.0e-05", ".inf", "-.inf", ".nan", "true", "True", "TRUE", "false", "yes",
         "No", "on", "OFF", "y", "n", "~", "null", "NULL", "", "abc", "a b", "  padded  ",
         "./data/synth/train/*.npz", "/tmp/run 1/val/*.npz", "pcf_torch/configs/pcf_5cm.json",
         "x-y", "-x", "a,b", "http://host/x", "2024-1-5", "12:30:45", "0o17",
         "[1, 2, 3]", "[]", "{}", "[1e-4, 1.0e-4, yes, ~, abc]",
         "[wall, floor, shower curtain]", "[49152, 24576, 8192, 2048, 512]", "[[1, 2], [3]]",
         "{a: 1, b: [x, y]}", '{"a": 1, "b": null}', '["wall", "floor"]', '"quoted"',
         "'single'", "'it''s'", '"a\\u00e9b"', "{a: }"]
# values that need more of YAML than the parser reads: it raises, never guesses
RAISE = ["2024-01-05", "2001-12-14t21:59:43.10-05:00", "- a", "a: 1", "&a x", "*a", "!!str 1",
         "x # c", "#c", "|", "[a: 1]", "{a}", "[1, 2", "'open", "[1] x", "=", "<<", "? x"]


def _same(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("raw", AGREE)
def test_override_values_parse_as_yaml_does(raw, monkeypatch):
    want = yaml.safe_load(raw)
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert _same(t_config.parse_value(raw), want), (raw, want)
    cfg = t_config.apply_overrides(t_config.Config(), [f"top={raw}", f"a.b.c={raw}"])
    assert _same(cfg.top, want) and _same(cfg.a.b.c, want)


def test_overrides_raise_rather_than_guess(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    for raw in RAISE:
        with pytest.raises(ValueError, match="key"):
            t_config.apply_overrides(t_config.Config(), [f"key={raw}"])
    with pytest.raises(ValueError, match="key=value"):
        t_config.apply_overrides(t_config.Config(), ["no_value"])
    with pytest.raises(ValueError, match="not a nested config"):
        t_config.apply_overrides(t_config.Config(x=1), ["x.y=2"])


def _abstract_inputs(cfg):
    """pcf_tpu's segmentation forward's inputs, as shapes: 3 feature
    channels (the backbone appends xyz), level i of 256 >> i points."""
    S = jax.ShapeDtypeStruct
    L = cfg.num_level
    sizes = [256 >> i for i in range(L)]
    pts = [S((n, 3), jnp.float32) for n in sizes]
    return (S((sizes[0], 3), jnp.float32), pts,
            [S((n, cfg.K_self[i]), jnp.int32) for i, n in enumerate(sizes)],
            [S((n, cfg.K_forward[i]), jnp.int32) for i, n in enumerate(sizes[1:])],
            [S((n, cfg.K_propagate[i]), jnp.int32) for i, n in enumerate(sizes[:-1])],
            pts, [S((n,), jnp.bool_) for n in sizes])


@pytest.mark.parametrize("name", NAMES)
def test_model_from_json_maps_onto_pcf_tpu_from_yaml(name):
    """Every leaf of pcf_tpu's variable tree for the YAML (jax.eval_shape of
    its init) maps through pcf_torch/convert.py onto a parameter or BN
    statistic of the port's model built from the JSON on the meta device,
    shape for shape, and every one of those is reached exactly once."""
    jcfg = j_config.load_config(_yaml(name))
    jmodel = JModel(jcfg)
    tree = jax.eval_shape(
        lambda k, f, p, es, ef, ep, n, m: jmodel.init(k, f, p, es, ef, ep, n, masks=m,
                                                      train=False),
        jax.random.PRNGKey(0), *_abstract_inputs(jcfg))
    with torch.device("meta"):
        model = PointConvFormer_Segmentation(t_config.load_config(_json(name)))
    modules = dict(model.named_modules())
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    hits = {}
    for collection in ("params", "batch_stats"):
        leaves = jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.float32(0), s.shape), dict(tree[collection]))
        for path, value in _flatten(leaves):
            for p, v in _unstack(path, value):
                key, v = _target(modules, p, v)  # KeyError: a leaf with no parameter
                assert key in own, (p, key)
                assert own[key] == v.shape, (key, own[key], v.shape)
                hits[key] = hits.get(key, 0) + 1
    assert set(tree) <= {"params", "batch_stats"}, sorted(tree)
    assert hits == dict.fromkeys(own, 1), sorted(set(own) ^ set(hits))[:5]
