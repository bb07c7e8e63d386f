"""pcf_torch's flat stage geometry (cfg.flat_geom) against pcf_tpu's: the
flat window resolve (pcf_tpu's Pallas kernel in interpret mode, the port's
plain version), the flat localize / split / VI, the flat WeightNet and
LinearBN in train mode with their running statistics, and the whole small
model. Same numpy inputs, weights carried by load_jax_variables.

The resolve is an exact selection (bit-exact); the geometry arithmetic and
the modules differ in summation order only (f32, rtol 1e-4, atol 1e-5 or
as stated); the whole model is held at tests/test_pallas_model.py's atol
5e-3 / rtol 1e-3. pcf_tpu's own flat-model test runs a larger batch in a
subprocess (an XLA:CPU crash late in a long process); this one uses
tests/test_fused_eval.py:132's small batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcf_tpu.data.pyramid as j_pyramid
from pcf_tpu.config import Config as JConfig, get_default_configs as j_defaults
from pcf_tpu.core import pack_scenes as j_pack
from pcf_tpu.data import synthetic_scene
from pcf_tpu.models import PointConvFormer_Segmentation as JSeg
from pcf_tpu.nn.norm import LinearBN as JLinearBN
from pcf_tpu.nn.weightnet import WeightNet as JWeightNet
from pcf_tpu.ops import vi_transform as j_vi
from pcf_tpu.ops.window import build_windows as j_windows, windowed_take_flat as j_take_flat

import pcf_torch.models.backbone as t_backbone
from pcf_torch.config import Config, get_default_configs
from pcf_torch.convert import load_jax_variables
from pcf_torch.core import pack_scenes
from pcf_torch.data import scene_to_item
from pcf_torch.entry import build
from pcf_torch.nn.norm import LinearBN
from pcf_torch.nn.weightnet import WeightNet
from pcf_torch.ops import vi_transform as t_vi
from pcf_torch.ops.kernels.window_resolve import windowed_take_flat_plain
from pcf_torch.ops.window import build_windows, windowed_take_flat
import pcf_torch.data.pyramid as t_pyramid

GRID = [0.3, 0.6, 1.2]
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def flat_inputs():
    """tests/test_flatgeom.py's local neighbourhoods: N = 512, K = 16, tile
    128, window 256; an [xyz | normal] table."""
    rng = np.random.default_rng(0)
    N, K = 512, 16
    nei = np.clip(np.arange(N)[:, None] + rng.integers(-60, 60, (N, K)), 0,
                  N - 1).astype(np.int32)
    xyz = rng.normal(size=(N, 3)).astype(np.float32)
    norms = rng.normal(size=(N, 3)).astype(np.float32)
    norms /= np.linalg.norm(norms, axis=-1, keepdims=True)
    return dict(nei=nei, xyz=xyz, norms=norms, table=np.concatenate([xyz, norms], -1),
                j=j_windows(nei, tile=128, window=256),
                t=build_windows(nei, tile=128, window=256))


@pytest.mark.parametrize("C", [3, 6])
def test_windowed_take_flat_bit_exact(flat_inputs, C):
    f = flat_inputs
    table = f["table"][:, :C].copy()
    want = np.asarray(j_take_flat(jnp.asarray(table), f["j"], interpret=True))
    got = windowed_take_flat(torch.from_numpy(table), f["t"])
    assert got.shape == want.shape == (512, 16 * C) and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), table[f["nei"]].reshape(512, -1))
    e = f["t"]
    np.testing.assert_array_equal(
        windowed_take_flat_plain(torch.from_numpy(table), e.window_rows, e.localT, 16).numpy(),
        want)


def test_flat_geometry_chain_matches_pcf_tpu(flat_inputs):
    """split_geom_flat, localize_flat and vi_transform_flat on the flat
    [xyz | normal] resolve, against pcf_tpu's selection-matrix forms."""
    f = flat_inputs
    flat6 = np.asarray(j_take_flat(jnp.asarray(f["table"]), f["j"], interpret=True))
    jx, jn = j_vi.split_geom_flat(jnp.asarray(flat6))
    tx, tn = t_vi.split_geom_flat(torch.from_numpy(flat6.copy()))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    jl = j_vi.localize_flat(jx, jnp.asarray(f["xyz"]))
    tl = t_vi.localize_flat(tx, torch.from_numpy(f["xyz"]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6, atol=1e-6)
    jv = j_vi.vi_transform_flat(jl, jn, jnp.asarray(f["norms"]))
    tv = t_vi.vi_transform_flat(tl, tn, torch.from_numpy(f["norms"]))
    assert tv.shape == (512, 16 * 12)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def _np_tree(tree):
    return {k: _np_tree(v) if hasattr(v, "items") else np.array(v) for k, v in tree.items()}


@pytest.mark.parametrize("module", ["WeightNet", "LinearBN"])
def test_flat_modules_in_train_mode_match_pcf_tpu(module):
    """A flat WeightNet / LinearBN in train mode (masked batch statistics
    pooled over K) and then in eval mode on the updated running statistics,
    against pcf_tpu's flat modules; the parameter tree is the 3-D one."""
    rng = np.random.default_rng(1)
    M, K, CIN, W = 96, 16, 12, 16
    x3 = rng.normal(size=(M, K, CIN)).astype(np.float32)
    mask = rng.random(M) < 0.8
    xf = x3.reshape(M, K * CIN)
    if module == "WeightNet":
        j3, jf = JWeightNet(W, hidden_unit=(16,)), JWeightNet(W, hidden_unit=(16,), flat_k=K)
        t = WeightNet(CIN, W, hidden_unit=(16,))
    else:
        j3, jf = JLinearBN(W), JLinearBN(W, flat_k=K)
        t = LinearBN(CIN, W)
    variables = _np_tree(j3.init(jax.random.PRNGKey(0), jnp.asarray(x3), mask=mask,
                                 train=False))
    load_jax_variables(t, variables)
    t.train()
    with torch.no_grad():
        got = t(torch.from_numpy(xf), torch.from_numpy(mask), K)
    want, upd = jf.apply(variables, jnp.asarray(xf), mask=jnp.asarray(mask), train=True,
                         mutable=["batch_stats"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = WeightNet(CIN, W, hidden_unit=(16,)) if module == "WeightNet" else LinearBN(CIN, W)
    load_jax_variables(ref, {"params": variables["params"],
                             "batch_stats": _np_tree(upd["batch_stats"])})
    stats = ref.state_dict()
    for key, v in t.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), stats[key].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=key)
    t.eval()
    with torch.no_grad():
        got = t(torch.from_numpy(xf), None, K)
    want = jf.apply({"params": variables["params"], "batch_stats": upd["batch_stats"]},
                    jnp.asarray(xf), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _cfg(cls, defaults, **kw):
    cfg = defaults(cls(), num_level=3, base_dim=8)
    cfg.update(guided_level=0, num_heads=2, resblocks=[0, 1, 1], mid_dim=[4, 4, 4],
               grid_size=GRID, num_classes=5, USE_PE=True, flat_geom=True)
    cfg.update(kw)
    return cfg


def _args(b):
    return (b.feats, list(b.points), list(b.edges_self), list(b.edges_forward),
            list(b.edges_propagate), list(b.norms))


def test_model_flat_geom_matches_pcf_tpu():
    """The whole small model with flat_geom, eval and train mode (logits and
    running statistics), pcf_tpu against the port; each hoisted stage goes
    through the flat resolve once."""
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pyramid, "_USE_NATIVE", False)
    mp.setattr(t_pyramid, "_USE_NATIVE", False)
    c, n, f, l = synthetic_scene(250, extent=4.0, num_classes=5, seed=3)
    kw = dict(bucket_multiple=128, window_tile=16, window_size=128)
    jb = j_pack([j_pyramid.scene_to_item(c, n, f, l, GRID, 8, 8, 8,
                                         rng=np.random.default_rng(3), morton=True)], **kw)
    tb = pack_scenes([scene_to_item(c, n, f, l, GRID, 8, 8, 8,
                                    rng=np.random.default_rng(3), morton=True)], **kw)
    mp.undo()
    jm = JSeg(_cfg(JConfig, j_defaults))
    init = _np_tree(jax.jit(lambda k: jm.init(k, *_args(jb), masks=list(jb.masks),
                                              train=False))(jax.random.PRNGKey(0)))
    want_train, upd = jax.jit(lambda v: jm.apply(
        v, *_args(jb), masks=list(jb.masks), train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(1)}))(init)
    after = {"params": init["params"], "batch_stats": _np_tree(upd["batch_stats"])}
    want = jm.apply(after, *_args(jb), masks=list(jb.masks), train=False)

    model = load_jax_variables(build(_cfg(Config, get_default_configs),
                                     device="cpu"), init)
    calls = []
    real = t_backbone.windowed_take_flat
    t_backbone.windowed_take_flat = lambda *a: calls.append(a[0].shape) or real(*a)
    try:
        model.train()
        with torch.no_grad():
            got_train = model.forward_batch(tb).numpy()
        model.eval()
        with torch.no_grad():
            got = model.forward_batch(tb).numpy()
    finally:
        t_backbone.windowed_take_flat = real
    assert len(calls) == 2 * 3  # levels 0, 1 and 2, in each of the two forwards
    assert all(s[1] == 6 for s in calls)  # [xyz | normal]
    m = np.asarray(jb.masks[0])
    np.testing.assert_allclose(got_train[m], np.asarray(want_train)[m], atol=5e-3, rtol=1e-3)
    stats = model.state_dict()
    ref = load_jax_variables(build(_cfg(Config, get_default_configs),
                                   device="cpu"), after)
    for key, v in ref.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(stats[key].numpy(), v.numpy(), atol=5e-3, rtol=1e-3,
                                       err_msg=key)
    np.testing.assert_allclose(got[m], np.asarray(want)[m], atol=5e-3, rtol=1e-3)
