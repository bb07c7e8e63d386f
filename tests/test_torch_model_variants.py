"""Model keys off the flagship, each flipped on its own: pcf_torch's
PointConvFormer_Segmentation against pcf_tpu's on tests/test_torch_model.py's
batch and configuration (3 levels, base_dim 8, scene seed 3, f32), with
pcf_tpu's PRNGKey(0) weights carried over by load_jax_variables. For each
key: the eval logits, the train-mode logits (BatchNorm on the batch's
statistics), and the eval logits after that pass has moved the running
statistics, each within test_torch_model.py's tolerance."""

import jax
import numpy as np
import pytest
import torch

import pcf_tpu.data.pyramid as jp
from pcf_tpu.config import Config as JConfig, get_default_configs as j_defaults
from pcf_tpu.core import pack_scenes as j_pack
from pcf_tpu.data import synthetic_scene as j_scene
from pcf_tpu.data.pyramid import scene_to_item as j_item
from pcf_tpu.models import PointConvFormer_Segmentation as JSeg

from pcf_torch.config import Config, get_default_configs
from pcf_torch.convert import load_jax_variables
from pcf_torch.core import pack_scenes
from pcf_torch.data import scene_to_item, synthetic_scene
from pcf_torch.entry import build

from test_torch_model import ATOL, GRID, RTOL, _args, _cfg

# each off the flagship's value (tests/test_torch_model.py's _cfg and the
# defaults): the keys pcf_tpu's configs set otherwise (use_level_1 and
# mid_dim_back in pcf_2cm_ptf2.yaml, layer_norm_guidance in every YAML) and
# the model's other switches
KEYS = [dict(use_level_1=False), dict(mid_dim_back=3), dict(layer_norm_guidance=True),
        dict(USE_VI=False), dict(USE_XYZ=False), dict(BATCH_NORM=False),
        dict(guided_level=1), dict(USE_PALLAS_KERNEL=False)]


@pytest.fixture(scope="module")
def batches():
    """test_torch_model.py's windowed batch, packed by each package."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jp, "_USE_NATIVE", False)
    kw = dict(window_tile=16, window_size=128)
    c, n, f, l = j_scene(250, extent=4.0, num_classes=5, seed=3)
    jb = j_pack([j_item(c, n, f, l, GRID, 8, 8, 8, rng=np.random.default_rng(3),
                        morton=True)], bucket_multiple=128, **kw)
    mp.undo()
    c, n, f, l = synthetic_scene(250, extent=4.0, num_classes=5, seed=3)
    tb = pack_scenes([scene_to_item(c, n, f, l, GRID, 8, 8, 8,
                                    rng=np.random.default_rng(3), morton=True)],
                     bucket_multiple=128, **kw)
    return jb, tb


@pytest.mark.parametrize("key", KEYS, ids=[next(iter(k)) for k in KEYS])
def test_model_key_matches_pcf_tpu(batches, key):
    jb, tb = batches
    jmodel = JSeg(_cfg(JConfig, j_defaults, **key))
    args, masks = _args(jb), list(jb.masks)
    variables = jax.jit(lambda k: jmodel.init(k, *args, masks=masks, train=False))(
        jax.random.PRNGKey(0))
    evaluate = jax.jit(lambda v: jmodel.apply(v, *args, masks=masks, train=False))
    train = jax.jit(lambda v: jmodel.apply(v, *args, masks=masks, train=True,
                                           mutable=["batch_stats"],
                                           rngs={"dropout": jax.random.PRNGKey(1)}))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    model = build(_cfg(Config, get_default_configs, **key), device="cpu")
    load_jax_variables(model, variables)
    m = np.asarray(jb.masks[0])

    def check(got, want, what):
        np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[m], atol=ATOL,
                                   rtol=RTOL, err_msg=f"{key}: {what}")

    with torch.no_grad():
        check(model.forward_batch(tb), evaluate(variables), "eval logits")
        want, upd = train(variables)
        model.train()
        check(model.forward_batch(tb), want, "train-mode logits")
        model.eval()
        stats = dict(variables, **upd)
        check(model.forward_batch(tb), evaluate(stats), "eval logits after the BN update")
