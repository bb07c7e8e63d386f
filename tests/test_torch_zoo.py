"""pcf_torch.models.zoo against pcf_tpu.models.zoo: each constructor's cfg
values, its parameter tree (names and shapes, mapped onto the flax tree
through tests/ref_loader.translate_key), and PCF_Tiny's backbone features on
one small scene with the weights carried by load_jax_variables. PCF_Large is
checked by its cfg and parameter tree only."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcf_tpu.models.zoo as jzoo
from pcf_tpu.core import pack_scenes as j_pack
from pcf_tpu.data import synthetic_scene as j_scene
from pcf_tpu.data.pyramid import scene_to_item as j_item

import pcf_torch.models.zoo as tzoo
from pcf_torch.convert import load_jax_variables
from pcf_torch.core import pack_scenes
from pcf_torch.data import scene_to_item, synthetic_scene

from ref_loader import translate_key

NAMES = ("PCF_Tiny", "PCF_Small", "PCF_Normal", "PCF_Large")


@pytest.mark.parametrize("name", NAMES)
def test_zoo_configs_match_pcf_tpu(name):
    (_, jcfg), (model, cfg) = getattr(jzoo, name)(0.1), getattr(tzoo, name)(0.1)
    assert dict(cfg) == dict(jcfg)
    assert type(model).__name__ == "PCF_Backbone" and model.cfg is cfg


def _flax_leaf(key: str):
    """(collection, flax path, transpose, block) for one of the port's
    state_dict keys. The port keeps flax's module names, where
    translate_key reads the reference's: its WeightNet `core`, which
    translate_key inserts, is dropped first, and block j of a residual stack
    `X.blocks.j` is leaf j of the stacked `X/blocks/block` (block = j)."""
    block = None
    m = re.match(r"(.*?)\.blocks\.(\d+)\.(.*)", key)
    if m:
        key, block = f"{m.group(1)}.{m.group(3)}", int(m.group(2))
    key = re.sub(r"\.core\.", ".", key)
    found = translate_key(key)
    if found is None:
        return None
    collection, path, transpose = found
    if m:
        at = len(m.group(1).split("."))
        path = path[:at] + ("blocks", "block") + path[at:]
    return collection, path, transpose, block


def _flax_shapes(name):
    """pcf_tpu's variable tree of the constructor `name`, as shapes
    (jax.eval_shape of init on abstract inputs)."""
    jmodel, jcfg = getattr(jzoo, name)(0.1)
    sizes = [256 >> i for i in range(jcfg.num_level)]
    S = jax.ShapeDtypeStruct
    pts = [S((n, 3), jnp.float32) for n in sizes]
    edges = [S((n, 16), jnp.int32) for n in sizes]
    fwd = [S((n, 16), jnp.int32) for n in sizes[1:]]
    masks = [S((n,), jnp.bool_) for n in sizes]
    tree = jax.eval_shape(
        lambda key, f, p, e, ef, m: jmodel.init(key, f, p, e, ef, p, masks=m, train=False),
        jax.random.PRNGKey(0), S((sizes[0], 3), jnp.float32), pts, edges, fwd, masks)
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if hasattr(v, "items"):
                walk(v, prefix + (k,))
            else:
                out[prefix + (k,)] = tuple(v.shape)

    for collection, node in tree.items():
        walk(node, (collection,))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_zoo_parameter_trees_map_onto_pcf_tpu(name):
    """Every parameter and BN statistic of the port's backbone lands on a
    flax leaf of the same shape (a stacked block's on its slice), and every
    flax leaf is reached, each stacked one once per block."""
    want = _flax_shapes(name)
    model, _ = getattr(tzoo, name)(0.1)
    hits = {}
    for key, t in model.state_dict().items():
        leaf = _flax_leaf(key)
        if leaf is None:
            continue
        collection, path, transpose, block = leaf
        full = (collection,) + path
        assert full in want, (key, full)
        shape = tuple(t.shape[::-1]) if transpose and t.dim() == 2 else tuple(t.shape)
        if block is not None:
            assert want[full][0] > block and want[full][1:] == shape, (key, want[full], shape)
        else:
            assert want[full] == shape, (key, want[full], shape)
        hits[full] = hits.get(full, 0) + 1
    for full, shape in want.items():
        stacked = "blocks" in full
        assert hits.get(full) == (shape[0] if stacked else 1), (full, hits.get(full))


@pytest.fixture(scope="module")
def tiny_scene():
    """One scene of 2,000 points through each package's pipeline, at
    PCF_Tiny(0.1)'s five grid levels, K = 16, packed with plain edges."""
    import pcf_tpu.data.pyramid as jp

    mp = pytest.MonkeyPatch()
    mp.setattr(jp, "_USE_NATIVE", False)
    grid = tzoo.PCF_Tiny(0.1)[1].grid_size
    c, n, f, l = j_scene(2000, extent=3.0, num_classes=5, seed=4)
    jb = j_pack([j_item(c, n, f, l, grid, 16, 16, 16, rng=np.random.default_rng(4))],
                bucket_multiple=256)
    c, n, f, l = synthetic_scene(2000, extent=3.0, num_classes=5, seed=4)
    tb = pack_scenes([scene_to_item(c, n, f, l, grid, 16, 16, 16,
                                    rng=np.random.default_rng(4))], bucket_multiple=256)
    yield jb, tb
    mp.undo()


def test_tiny_backbone_features_match_pcf_tpu(tiny_scene):
    """PCF_Tiny(0.1)'s feature list on the same scene and weights, every
    level within 1e-4 in f32 (tests/test_model.py's comparison of
    pcf_tpu's cfgs, here across the two packages)."""
    jb, tb = tiny_scene
    jmodel, _ = jzoo.PCF_Tiny(0.1)
    args = (jb.feats, list(jb.points), list(jb.edges_self), list(jb.edges_forward),
            list(jb.norms))
    variables = jmodel.init(jax.random.PRNGKey(0), *args, masks=list(jb.masks), train=False)
    want = jax.jit(lambda v: jmodel.apply(v, *args, masks=list(jb.masks), train=False))(
        variables)
    model, _ = tzoo.PCF_Tiny(0.1)
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, dict(variables)))
    model.eval()
    with torch.no_grad():
        got = model(tb.feats, list(tb.points), list(tb.edges_self), list(tb.edges_forward),
                    list(tb.norms), masks=list(tb.masks))
    assert len(got) == len(want) == 5
    for level, (g, w) in enumerate(zip(got, want)):
        m = np.asarray(jb.masks[level])
        assert m.sum() > 0, level
        np.testing.assert_allclose(g.numpy()[m], np.asarray(w)[m], atol=1e-4, rtol=1e-4,
                                   err_msg=f"level {level}")
