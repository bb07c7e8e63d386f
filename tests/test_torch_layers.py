"""pcf_torch's conv layers and MaskedBatchNorm against pcf_tpu's, with the
weights carried by load_jax_variables, in eval and in train mode (outputs
and the updated running statistics), on a small windowed pyramid. The
fused case is the slice's configuration (USE_PALLAS_KERNEL,
fused_min_points=0: pcf_tpu's Pallas kernels in interpret mode, pcf_torch's
kernel wrappers on their plain versions); the unfused case runs LinearBN."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcf_tpu.data.pyramid as j_pyramid
from pcf_tpu.config import Config as JConfig, get_default_configs as j_defaults
from pcf_tpu.core import pack_scenes as j_pack
from pcf_tpu.data import synthetic_scene
from pcf_tpu.nn import layers as j_layers
from pcf_tpu.nn.norm import MaskedBatchNorm as JBN

from pcf_torch.config import Config, get_default_configs
from pcf_torch.convert import load_jax_variables
from pcf_torch.core import pack_scenes
from pcf_torch.data import scene_to_item
from pcf_torch.nn import layers as t_layers
from pcf_torch.nn.norm import MaskedBatchNorm as TBN
import pcf_torch.data.pyramid as t_pyramid

GRID = [0.3, 0.6, 1.2]
# f32 on both sides; the two differ only in summation order
TOL = dict(atol=1e-4, rtol=1e-4)


def _cfg(cls, defaults, fused):
    cfg = defaults(cls(), num_level=3, base_dim=8)
    cfg.update(USE_PE=True, USE_PALLAS_KERNEL=fused, fused_min_points=0,
               resolve_impl="pallas")
    return cfg


@pytest.fixture(scope="module")
def batches():
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pyramid, "_USE_NATIVE", False)
    mp.setattr(t_pyramid, "_USE_NATIVE", False)
    coord, norm, feats, labels = synthetic_scene(250, extent=4.0, num_classes=5, seed=3)
    kw = dict(bucket_multiple=128, window_tile=16, window_size=128)
    args = (coord, norm, feats, labels, GRID, 8, 8, 8)
    jb = j_pack([j_pyramid.scene_to_item(*args, rng=np.random.default_rng(3),
                                         morton=True)], **kw)
    tb = pack_scenes([scene_to_item(*args, rng=np.random.default_rng(3), morton=True)], **kw)
    mp.undo()
    return jb, tb


def _case(name, b, rng):
    """(layer constructor args, call args, output mask) of one layer."""
    P, Nm, E = b.points, b.norms, b.edges_self
    if name == "PointConv":
        f = rng.standard_normal((P[0].shape[0], 6)).astype(np.float32)
        return ((6, 8, (12, 4)),
                (P[0], f, E[0], Nm[0], None, None, None, None, b.masks[0], None), 0)
    if name == "PointConvStridePE":
        f = rng.standard_normal((P[0].shape[0], 8)).astype(np.float32)
        return ((8, 16, (12, 4)), (P[0], f, b.edges_forward[0], Nm[0], P[1], Nm[1],
                                   None, None, b.masks[0], b.masks[1]), 1)
    if name == "PCFLayer":
        f = rng.standard_normal((P[1].shape[0], 16)).astype(np.float32)
        return ((16, 24, (12, 4), 2), (P[1], f, b.edges_forward[1], Nm[1], P[2], Nm[2],
                                       None, None, b.masks[1], b.masks[2]), 2)
    f = rng.standard_normal((P[1].shape[0], 16)).astype(np.float32)
    skip = rng.standard_normal((P[0].shape[0], 8)).astype(np.float32)
    return ((16, 8, (12, 1), (8, 8)), (P[1], f, b.edges_propagate[0], Nm[1], P[0], Nm[0],
                                       skip, None, b.masks[0], b.masks[1]), 0)


def _to_torch(x):
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", ["PointConv", "PointConvStridePE", "PCFLayer",
                                  "PointConvTransposePE"])
def test_conv_layer_matches_pcf_tpu(batches, name, fused):
    jb, tb = batches
    ctor, jargs, lvl = _case(name, jb, np.random.default_rng(11))
    _, targs, _ = _case(name, tb, np.random.default_rng(11))
    targs = tuple(_to_torch(a) for a in targs)
    jl = getattr(j_layers, name)(*ctor[:2], _cfg(JConfig, j_defaults, fused), *ctor[2:])
    tl = getattr(t_layers, name)(*ctor[:2], _cfg(Config, get_default_configs, fused),
                                 *ctor[2:])
    jargs = tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in jargs)
    variables = jl.init(jax.random.PRNGKey(0), *jargs, train=False)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    load_jax_variables(tl, variables)
    m = np.asarray(jb.masks[lvl])

    tl.eval()
    with torch.no_grad():
        got = tl(*targs)[0].numpy()
    want = np.asarray(jl.apply(variables, *jargs, train=False)[0])
    np.testing.assert_allclose(got[m], want[m], **TOL)

    tl.train()
    with torch.no_grad():
        got = tl(*targs)[0].numpy()
    (want, _), upd = jl.apply(variables, *jargs, train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(got[m], np.asarray(want)[m], **TOL)
    ref = getattr(t_layers, name)(*ctor[:2], _cfg(Config, get_default_configs, fused),
                                  *ctor[2:])
    load_jax_variables(ref, {"params": variables["params"],
                             "batch_stats": jax.tree_util.tree_map(
                                 np.asarray, dict(upd["batch_stats"]))})
    want_state = ref.state_dict()
    n_stats = 0
    for key, v in tl.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want_state[key].numpy(), **TOL,
                                       err_msg=key)
            n_stats += 1
    assert n_stats > 0


def test_fused_min_points_threshold_is_rejected():
    # pcf_tpu's thresholds are TPU crossovers; the port has none to apply
    cfg = _cfg(Config, get_default_configs, True)
    cfg.fused_min_points = 20480
    with pytest.raises(NotImplementedError, match="fused_min_points"):
        t_layers.PCFLayer(16, 24, cfg, (12, 4), 2)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_masked_batchnorm_matches_pcf_tpu(masked):
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((40, 6, 5)) * 3 + 1).astype(np.float32)
    mask = rng.uniform(size=40) < 0.7 if masked else None
    variables = {"params": {"scale": rng.uniform(0.5, 2, 5).astype(np.float32),
                            "bias": rng.standard_normal(5).astype(np.float32)},
                 "batch_stats": {"mean": rng.standard_normal(5).astype(np.float32),
                                 "var": rng.uniform(0.5, 2, 5).astype(np.float32)}}
    jbn = JBN(5)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    tbn = load_jax_variables(TBN(5), variables)

    tbn.eval()
    np.testing.assert_allclose(
        tbn(torch.from_numpy(x), tm).detach().numpy(),
        np.asarray(jbn.apply(variables, jnp.asarray(x), mask=jm, use_running_average=True)),
        **TOL)
    tbn.train()
    got = tbn(torch.from_numpy(x), tm).detach().numpy()
    want, upd = jbn.apply(variables, jnp.asarray(x), mask=jm, use_running_average=False,
                          mutable=["batch_stats"])
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), **TOL)
