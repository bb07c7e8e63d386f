"""The port's off-default variants, module by module, against pcf_tpu on the
same numpy inputs and weights: MultiHeadGuidanceQK (attention_type other than
"subtraction"), the channel-major stage geometry (cm_geom:
windowed_take_cm, localize_cm, vi_transform_cm, mirroring
tests/test_cmgeom.py), maybe_remat (remat_layers, remat_deconv) and
PointConvFormer_Classification; the new parameter names through
tests/ref_loader.translate_key. The whole segmentation model with each key
flipped is tests/test_torch_model_variants.py."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcf_tpu.data.pyramid as jp
from pcf_tpu.config import Config as JConfig, get_default_configs as j_defaults
from pcf_tpu.core import pack_scenes as j_pack
from pcf_tpu.data.pyramid import scene_to_item as j_item
from pcf_tpu.models.classification import PointConvFormer_Classification as JCls
from pcf_tpu.models import PointConvFormer_Segmentation as JSeg

import pcf_torch.data.pyramid as t_pyramid
from pcf_torch.config import Config, get_default_configs
from pcf_torch.convert import load_jax_variables
from pcf_torch.core import pack_scenes
from pcf_torch.data import scene_to_item
from pcf_torch.entry import build
from pcf_torch.models import PointConvFormer_Classification
from pcf_torch.models.backbone import maybe_remat
from pcf_torch.nn.guidance import MultiHeadGuidanceQK
from pcf_torch.nn.layers import (PCFLayer, PointConv, PointConvStridePE, PointConvTransposePE,
                                 PointTransformerLayer, set_generator)
from pcf_torch.ops.vi_transform import VI_coordinate_transform, localize_cm, vi_transform_cm
from pcf_torch.ops.window import build_windows, windowed_take_cm
from pcf_torch.train.loss import cross_entropy_loss

from ref_loader import translate_key
from test_classification import _shape_cloud
from test_torch_model import ATOL, RTOL, _cfg
from test_torch_model_variants import batches  # noqa: F401  (fixture)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


# ---- MultiHeadGuidanceQK ---------------------------------------------------

def test_qk_guidance_matches_pcf_tpu_and_moves_its_statistics_twice():
    """sigmoid(q.k0 / sqrt(16)) per head, through one qk_linear LinearBN on q
    then on k: eval on the running statistics, train on the batch's, and
    after the train pass the running statistics moved twice, q first, as
    flax moves them (tolerance of tests/test_torch_model.py)."""
    from pcf_tpu.nn.guidance import MultiHeadGuidanceQK as JQK

    rng = np.random.default_rng(5)
    M, K, C, H = 40, 8, 24, 4
    q, k = (rng.standard_normal((M, K, C)).astype(np.float32) for _ in range(2))
    mask = rng.random(M) < 0.8
    jmod = JQK(H, C, key_dim=16)
    variables = _np(jmod.init(jax.random.PRNGKey(2), q, k, mask=mask, train=False))
    stats = variables["batch_stats"]["qk_linear"]["bn"]
    stats["mean"] = rng.standard_normal(stats["mean"].shape).astype(np.float32)
    stats["var"] = rng.random(stats["var"].shape).astype(np.float32) + 0.5
    want_eval = jmod.apply(variables, q, k, mask=mask, train=False)
    want_train, upd = jmod.apply(variables, q, k, mask=mask, train=True,
                                 mutable=["batch_stats"])

    mod = load_jax_variables(MultiHeadGuidanceQK(C, H, C, key_dim=16), variables)
    tq, tk, tm = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(mask)
    mod.eval()
    with torch.no_grad():
        np.testing.assert_allclose(mod(tq, tk, tm).numpy(), want_eval, atol=1e-5, rtol=1e-5)
        mod.train()
        np.testing.assert_allclose(mod(tq, tk, tm).numpy(), want_train, atol=1e-5, rtol=1e-5)
    bn = upd["batch_stats"]["qk_linear"]["bn"]
    np.testing.assert_allclose(mod.qk_linear.bn.running_mean.numpy(), bn["mean"], atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(mod.qk_linear.bn.running_var.numpy(), bn["var"], atol=1e-6,
                               rtol=1e-5)
    once = load_jax_variables(MultiHeadGuidanceQK(C, H, C, key_dim=16), variables)
    once.train()
    with torch.no_grad():
        once.qk_linear(tq, tm)  # one move: not where the two calls leave it
    assert not torch.allclose(once.qk_linear.bn.running_mean, mod.qk_linear.bn.running_mean)


# ---- cm_geom ---------------------------------------------------------------

def _local_edges(N, K, spread, seed=0):
    rng = np.random.default_rng(seed)
    base = np.arange(N)[:, None]
    return np.clip(base + rng.integers(-spread, spread, (N, K)), 0, N - 1).astype(np.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [3, 6])
def test_windowed_take_cm_is_an_exact_channel_major_gather(C, dtype):
    """out[c, m, k] == table[nei[m, k], c], bit for bit, as pcf_tpu's
    windowed_take_cm (tests/test_cmgeom.py)."""
    from pcf_tpu.ops.window import build_windows as j_build, windowed_take_cm as j_take_cm

    N, K = 1024, 16
    nei = _local_edges(N, K, 120, seed=21)
    rng = np.random.default_rng(22)
    table = torch.from_numpy(rng.normal(size=(N, C)).astype(np.float32)).to(dtype)
    out = windowed_take_cm(table, build_windows(nei, tile=128, window=512))
    assert out.shape == (C, N, K) and out.dtype == dtype
    assert torch.equal(out, table[torch.from_numpy(nei).long()].permute(2, 0, 1))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = j_take_cm(jnp.asarray(table.float().numpy(), jdt), j_build(nei, tile=128, window=512))
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("use_vi", [True, False], ids=["vi", "xyz"])
def test_cm_localize_and_vi_match_pcf_tpu(use_vi):
    """localize_cm and vi_transform_cm against pcf_tpu's on the same gather
    (f32 round-off), and against the port's 3-D VI_coordinate_transform."""
    from pcf_tpu.ops.vi_transform import localize_cm as j_loc, vi_transform_cm as j_vi

    N, K = 512, 16
    rng = np.random.default_rng(23)
    nei = _local_edges(N, K, 60, seed=24)
    xyz = rng.normal(size=(N, 3)).astype(np.float32)
    norms = rng.normal(size=(N, 3)).astype(np.float32)
    norms /= np.linalg.norm(norms, axis=-1, keepdims=True)
    we = build_windows(nei, tile=128, window=256)
    table = torch.from_numpy(np.concatenate([xyz, norms], -1) if use_vi else xyz)
    g = windowed_take_cm(table, we)
    loc = localize_cm(g[:3], torch.from_numpy(xyz))
    np.testing.assert_allclose(loc.numpy(), np.asarray(j_loc(jnp.asarray(g[:3].numpy()),
                                                             jnp.asarray(xyz))),
                               rtol=1e-6, atol=1e-6)
    if not use_vi:
        return
    vi = vi_transform_cm(loc, g[3:], torch.from_numpy(norms))
    assert vi.shape == (12, N, K)
    want = j_vi(jnp.asarray(loc.numpy()), jnp.asarray(g[3:].numpy()), jnp.asarray(norms))
    np.testing.assert_allclose(vi.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    vi3 = VI_coordinate_transform(loc.permute(1, 2, 0), g[3:].permute(1, 2, 0),
                                  torch.from_numpy(norms))
    torch.testing.assert_close(vi.permute(1, 2, 0), vi3, rtol=1e-6, atol=1e-6)


# ---- maybe_remat -----------------------------------------------------------

def test_maybe_remat_tests_the_class_by_identity():
    """remat_layers takes every layer class; remat_deconv only
    PointConvTransposePE itself: a class that only bears its name is not
    taken (pcf_tpu's maybe_remat compares cls.__name__)."""
    impostor = type("PointConvTransposePE", (PointConvStridePE,), {})
    deconv, layers = Config(remat_deconv=True), Config(remat_layers=True)
    assert maybe_remat(PointConvTransposePE, deconv)
    assert not maybe_remat(impostor, deconv)
    assert not any(maybe_remat(c, deconv) for c in (PointConv, PointConvStridePE, PCFLayer,
                                                    PointTransformerLayer))
    assert all(maybe_remat(c, layers) for c in (PointConv, PointConvStridePE, PCFLayer,
                                                PointConvTransposePE, PointTransformerLayer,
                                                impostor))
    assert not maybe_remat(PointConvTransposePE, Config())


@pytest.mark.parametrize("key", ["remat_layers", "remat_deconv"])
def test_remat_keeps_gradients_and_moves_statistics_once(batches, key):  # noqa: F811
    """A train-mode forward and backward with DropPath and dropout on, with
    and without the key, from the same weights and seed: the same loss, the
    same gradient of every parameter and the same BN running statistics
    (moved once: the recompute leaves them alone and replays the draws)."""
    _, tb = batches
    out = {}
    for on in (False, True):
        cfg = _cfg(Config, get_default_configs, drop_path_rate=0.3, dropout_rate=0.2,
                   remat_blocks=False, **{key: on})
        model = build(cfg, device="cpu", seed=3)
        model.train()
        set_generator(model, torch.Generator().manual_seed(9))
        loss, _ = cross_entropy_loss(model.forward_batch(tb), tb.labels, mask=tb.masks[0])
        loss.backward()
        out[on] = (loss.detach(), {k: p.grad for k, p in model.named_parameters()},
                   {k: v for k, v in model.state_dict().items() if "running" in k})
    torch.testing.assert_close(out[True][0], out[False][0], atol=0, rtol=0)
    for k, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], g, atol=1e-6, rtol=1e-5, msg=k)
    for k, v in out[False][2].items():
        torch.testing.assert_close(out[True][2][k], v, atol=0, rtol=0, msg=k)


# ---- classification --------------------------------------------------------

CLS_GRID = [0.2, 0.4]


def _cls_cfg(mod, defaults):
    cfg = defaults(mod(), num_level=2, base_dim=8)
    cfg.update(guided_level=0, num_heads=2, resblocks=[0, 1], mid_dim=[4, 4],
               grid_size=CLS_GRID, num_classes=2, USE_PE=True, BATCH_SIZE=4,
               dropout_fc=0.0, max_clouds=4)
    return cfg


@pytest.fixture(scope="module")
def clouds():
    """tests/test_classification.py's packed batch of 4 clouds (a sphere or
    a disk each), packed by both packages from the same points."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jp, "_USE_NATIVE", False)
    mp.setattr(t_pyramid, "_USE_NATIVE", False)
    out = []
    for pack, item in ((j_pack, j_item), (pack_scenes, scene_to_item)):
        rng = np.random.default_rng(0)
        scenes = []
        for y in (0, 1, 0, 1):
            pts, norms = _shape_cloud("sphere" if y else "disk", 120, rng)
            scenes.append(item(pts, norms, np.ones((120, 3), np.float32),
                               np.full(120, y, np.int64), CLS_GRID, 8, 8, 8,
                               rng=np.random.default_rng(y)))
        out.append(pack(scenes, level_caps=[1024, 512]))
    mp.undo()
    return out


@pytest.mark.parametrize("bids", [True, False], ids=["bids", "one_cloud"])
def test_classification_matches_pcf_tpu(clouds, bids):
    """The logits of 4 clouds (bids: the pool segmented by the coarsest
    level's cloud ids) or of the batch as one cloud: eval, and train mode
    (BN on the batch's statistics), on pcf_tpu's PRNGKey(0) weights."""
    jb, tb = clouds
    jmodel = JCls(_cls_cfg(JConfig, j_defaults))
    args = (jb.feats, list(jb.points), list(jb.edges_self), list(jb.edges_forward),
            list(jb.norms))
    kw = dict(masks=list(jb.masks), bids=jb.bids[-1] if bids else None)
    variables = _np(jax.jit(lambda k: jmodel.init(k, *args, train=False, **kw))(
        jax.random.PRNGKey(0)))
    want_eval = jax.jit(lambda v: jmodel.apply(v, *args, train=False, **kw))(variables)
    want_train, _ = jax.jit(lambda v: jmodel.apply(v, *args, train=True,
                                                   mutable=["batch_stats"], **kw))(variables)
    model = load_jax_variables(PointConvFormer_Classification(
        _cls_cfg(Config, get_default_configs)), variables)
    with torch.no_grad():
        model.eval()
        got = model.forward_batch(tb, tb.bids[-1] if bids else None)
        assert got.shape == ((4, 2) if bids else (1, 2))
        np.testing.assert_allclose(got.numpy(), want_eval, atol=ATOL, rtol=RTOL)
        model.train()
        np.testing.assert_allclose(model.forward_batch(tb, tb.bids[-1] if bids else None)
                                   .numpy(), want_train, atol=ATOL, rtol=RTOL)


# ---- names -----------------------------------------------------------------

# the reference's torch Sequential indices of PointTransformerLayer, which
# translate_key reads (linear_p: Linear_BN, ReLU, Linear; linear_w: ReLU,
# Linear_BN, ReLU, Linear); the port keeps flax's names
_REFERENCE_PT = {"linear_p_1": "linear_p_2", "linear_w_0": "linear_w_1",
                 "linear_w_1": "linear_w_3"}


def _flax_leaf(key: str):
    """(collection, flax path) of one of the port's state_dict keys through
    translate_key, as tests/test_torch_zoo.py maps them (WeightNet `core`
    and the stacked blocks), with PointTransformerLayer's names as the
    reference's."""
    m = re.match(r"(.*?)\.blocks\.(\d+)\.(.*)", key)
    if m:
        key = f"{m.group(1)}.{m.group(3)}"
    key = re.sub(r"\.core\.", ".", key)
    key = ".".join(_REFERENCE_PT.get(t, t) for t in key.split("."))
    found = translate_key(key)
    if found is None:
        return None
    collection, path, _ = found
    if m:
        at = len(m.group(1).split("."))
        path = path[:at] + ("blocks", "block") + path[at:]
    return (collection,) + path


def _leaves(tree):
    out = set()

    def walk(node, prefix):
        for k, v in node.items():
            if hasattr(v, "items"):
                walk(v, prefix + (k,))
            else:
                out.add(prefix + (k,))

    walk(tree, ())
    return out


@pytest.mark.parametrize("which", ["transformer_type", "attention_type", "classification"])
def test_new_parameter_names_map_through_translate_key(batches, clouds, which):  # noqa: F811
    """Every parameter and BN statistic of the port's PointTransformerLayer,
    MultiHeadGuidanceQK (qk_linear) and classification head (fc1, fc2) lands
    on a leaf of pcf_tpu's variable tree through translate_key, and every
    leaf is reached."""
    if which == "classification":
        jb, _ = clouds
        cfgs = (_cls_cfg(JConfig, j_defaults), _cls_cfg(Config, get_default_configs))
        jmodel, model = JCls(cfgs[0]), PointConvFormer_Classification(cfgs[1])
        args = (jb.feats, list(jb.points), list(jb.edges_self), list(jb.edges_forward),
                list(jb.norms))
    else:
        jb, _ = batches
        key = {which: "PointTransformer" if which == "transformer_type" else "QK"}
        jmodel = JSeg(_cfg(JConfig, j_defaults, **key))
        model = build(_cfg(Config, get_default_configs, **key), device="cpu")
        args = (jb.feats, list(jb.points), list(jb.edges_self), list(jb.edges_forward),
                list(jb.edges_propagate), list(jb.norms))
    tree = jax.eval_shape(lambda k: jmodel.init(k, *args, masks=list(jb.masks), train=False),
                          jax.random.PRNGKey(0))
    want = _leaves({c: tree[c] for c in ("params", "batch_stats")})
    got = {_flax_leaf(k) for k in model.state_dict()} - {None}
    assert got == want, (sorted(got - want)[:5], sorted(want - got)[:5])
    names = {"transformer_type": ("linear_q", "linear_p_1", "bn_w", "linear_w_1"),
             "attention_type": ("qk_linear",), "classification": ("fc1", "fc2")}[which]
    assert all(any(n in path for path in got) for n in names)
