"""Whole-model parity: pcf_torch's PointConvFormer_Segmentation against
pcf_tpu's on one windowed batch, same weights (carried by
load_jax_variables), in the configuration whose main path runs the kernels:
USE_PALLAS_KERNEL, fused_min_points=0, resolve_impl="pallas". pcf_tpu runs
its Pallas kernels in interpret mode on the CPU; pcf_torch runs its kernels'
plain versions."""

import jax
import numpy as np
import pytest
import torch

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
import pcf_torch.data.pyramid as t_pyramid

GRID = [0.3, 0.6, 1.2]
# the tolerance tests/test_pallas_model.py holds between pcf_tpu's own paths
ATOL, RTOL = 5e-3, 1e-3


def _cfg(cls_config, defaults, **kw):
    cfg = defaults(cls_config(), num_level=3, base_dim=8)
    cfg.update(guided_level=0, num_heads=2, resblocks=[0, 1, 1], mid_dim=[4, 4, 4],
               grid_size=GRID, num_classes=5, USE_PE=True, USE_PALLAS_KERNEL=True,
               fused_min_points=0, resolve_impl="pallas")
    cfg.update(kw)
    return cfg


def _args(b):
    return (b.feats, list(b.points), list(b.edges_self), list(b.edges_forward),
            list(b.edges_propagate), list(b.norms))


@pytest.fixture(scope="module")
def pair(monkeypatch_module):
    import pcf_tpu.data.pyramid as jp

    monkeypatch_module.setattr(jp, "_USE_NATIVE", False)
    monkeypatch_module.setattr(t_pyramid, "_USE_NATIVE", False)
    kw = dict(window_tile=16, window_size=128)
    c, n, f, l = j_scene(250, extent=4.0, num_classes=5, seed=3)
    jb = j_pack([j_item(c, n, f, l, GRID, 8, 8, 8, rng=np.random.default_rng(3),
                        morton=True)], bucket_multiple=128, **kw)
    c, n, f, l = synthetic_scene(250, extent=4.0, num_classes=5, seed=3)
    tb = pack_scenes([scene_to_item(c, n, f, l, GRID, 8, 8, 8,
                                    rng=np.random.default_rng(3), morton=True)],
                     bucket_multiple=128, **kw)
    jmodel = JSeg(_cfg(JConfig, j_defaults))
    variables = jax.jit(lambda k: jmodel.init(k, *_args(jb), masks=list(jb.masks),
                                              train=False))(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    return jmodel, jb, variables, tb


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_segmentation_logits_match_pcf_tpu(pair):
    jmodel, jb, variables, tb = pair
    model = build(_cfg(Config, get_default_configs), device="cpu")
    load_jax_variables(model, variables)
    with torch.no_grad():
        got = model.forward_batch(tb).numpy()
    want = np.asarray(jmodel.apply(variables, *_args(jb), masks=list(jb.masks),
                                   train=False))
    m = np.asarray(jb.masks[0])
    assert got.shape == want.shape
    np.testing.assert_allclose(got[m], want[m], atol=ATOL, rtol=RTOL)


def test_train_mode_updates_running_stats_like_pcf_tpu(pair):
    """One train-mode forward (BN calibration, as bench.py does) moves the
    running statistics as pcf_tpu's mutable batch_stats pass does."""
    jmodel, jb, variables, tb = pair
    model = build(_cfg(Config, get_default_configs), device="cpu")
    load_jax_variables(model, variables)
    model.train()
    with torch.no_grad():
        got = model.forward_batch(tb).numpy()
    want, upd = jmodel.apply(variables, *_args(jb), masks=list(jb.masks), train=True,
                             mutable=["batch_stats"],
                             rngs={"dropout": jax.random.PRNGKey(1)})
    m = np.asarray(jb.masks[0])
    np.testing.assert_allclose(got[m], np.asarray(want)[m], atol=ATOL, rtol=RTOL)
    ref = build(_cfg(Config, get_default_configs), device="cpu")
    load_jax_variables(ref, {"params": variables["params"],
                             "batch_stats": jax.tree_util.tree_map(
                                 np.asarray, dict(upd["batch_stats"]))})
    want_state = ref.state_dict()
    for key, v in model.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want_state[key].numpy(),
                                       atol=ATOL, rtol=RTOL, err_msg=key)
