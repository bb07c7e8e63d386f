"""pcf_torch's fused_eval path (nn/fused_eval.py, kernel E's plain version in
ops/kernels/layer_eval.py) against pcf_tpu's (nn/fused_eval.py, the Pallas
kernel of attic/eval_kernel.py in interpret mode), on the same numpy inputs,
weights carried by load_jax_variables.

Tolerances: f32 at atol/rtol 1e-4 where both sides fold the same weights
(they differ in summation order only); bf16 within 1e-2 of the output's
scale, as a contraction sum rounded to bf16 may land one bf16 step away.
pcf_tpu's bf16 kernel reads the geometry through a hi/lo bf16 pair (about
2^-16 relative) where the port reads it in f32; for a self edge that turns
the zero offset into the pair's residual, whose normalised direction is
arbitrary (theta 2, 3, 5 and 6 of those edges come out O(1) instead of 0).
So the coordinates and normals here are bf16 values, which the pair carries
exactly. Fused against unfused, in
either package, differs by the fold of every Linear+BN pair: atol 5e-3 /
rtol 1e-2 per layer (tests/test_fused_eval.py), atol 5e-3 / rtol 1e-3 for
the whole model against pcf_tpu (tests/test_pallas_model.py's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcf_tpu.data.pyramid as j_pyramid
import pcf_tpu.nn.fused_eval as j_fe
from pcf_tpu.attic.eval_kernel import fused_layer_eval as j_fused_layer_eval
from pcf_tpu.config import Config as JConfig, get_default_configs as j_defaults
from pcf_tpu.core import pack_scenes as j_pack
from pcf_tpu.data import synthetic_scene
from pcf_tpu.models import PointConvFormer_Segmentation as JSeg
from pcf_tpu.nn import layers as j_layers
from pcf_tpu.ops.window import build_windows as j_windows

import pcf_torch.nn.fused_eval as t_fe
from pcf_torch.config import Config, get_default_configs
from pcf_torch.convert import load_jax_variables
from pcf_torch.core import pack_scenes
from pcf_torch.data import scene_to_item
from pcf_torch.entry import build, build_training
from pcf_torch.nn import layers as t_layers
from pcf_torch.nn.fused import FusedConvLinear
from pcf_torch.nn.norm import LinearBN
from pcf_torch.ops.kernels.layer_eval import fused_layer_eval_plain
from pcf_torch.ops.window import WindowedEdges, build_windows
import pcf_torch.data.pyramid as t_pyramid

N, M, K = 256, 128, 8
F32 = dict(atol=1e-4, rtol=1e-4)
FOLD = dict(atol=5e-3, rtol=1e-2)
MODEL = dict(atol=5e-3, rtol=1e-3)
GRID = [0.3, 0.6, 1.2]


def _close_bf16(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-2 * scale, rtol=1e-2)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


def _bf16_exact(x):
    """f32 values that bf16 represents exactly (see the module docstring)."""
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


@pytest.fixture(scope="module")
def geom():
    """tests/test_fused_eval.py's geometry: self, strided and upsampling
    kNN edges at tile 16, window 128, in both packages; coordinates and
    normals bf16-exact."""
    rng = np.random.default_rng(0)
    xyz = _bf16_exact(rng.normal(size=(N, 3)))
    nv = rng.normal(size=(N, 3))
    nv = _bf16_exact(nv / np.linalg.norm(nv, axis=1, keepdims=True))
    d = ((xyz[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
    dM = ((xyz[:M, None, :] - xyz[None, :, :]) ** 2).sum(-1)
    dT = ((xyz[:, None, :] - xyz[None, :M, :]) ** 2).sum(-1)
    neis = {"self": np.argsort(d, axis=1)[:, :K], "fwd": np.argsort(dM, axis=1)[:, :K],
            "up": np.argsort(dT, axis=1)[:, :K]}
    g = {"xyz": xyz, "norm": nv, "sxyz": xyz[:M], "snorm": nv[:M]}
    for k, nei in neis.items():
        nei = nei.astype(np.int32)
        g["j" + k] = j_windows(nei, tile=16, window=128)
        g["t" + k] = build_windows(nei, tile=16, window=128)
    return g


def _cfg(cls, defaults, **kw):
    cfg = defaults(cls(), num_level=3, base_dim=8)
    cfg.update(num_heads=2, mid_dim=[4, 4, 4], USE_PE=True)
    cfg.update(kw)
    return cfg


def _randomize_bn(variables, rng):
    """Running statistics and BN affine parameters away from their initial
    values, so that every fold does work."""
    def walk(tree, stats):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, stats)
            elif stats and k == "mean":
                tree[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
            elif stats and k == "var":
                tree[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            elif not stats and k == "scale":
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    walk(variables["params"], False)
    walk(variables["batch_stats"], True)
    return variables


def _to_np_tree(tree):
    return {k: _to_np_tree(v) if hasattr(v, "items") else np.array(v)
            for k, v in tree.items()}


# (constructor args, call args) of tests/test_fused_eval.py's six cases:
# feats width, pcf_tpu kwargs, port positional constructor args, and the
# call's (xyz, edges, norms[, centres, centre normals]) keys
CASES = {
    "PointConv": (7, dict(in_channel=7, out_channel=16, weightnet=(12, 4)),
                  (7, 16, (12, 4)), ("xyz", "self", "norm")),
    "StridePE_residual": (16, dict(in_channel=16, out_channel=16, weightnet=(12, 4)),
                          (16, 16, (12, 4)), ("xyz", "self", "norm")),
    "StridePE_strided": (16, dict(in_channel=16, out_channel=32, weightnet=(12, 4)),
                         (16, 32, (12, 4)), ("xyz", "fwd", "norm", "sxyz", "snorm")),
    "PCF_residual": (16, dict(in_channel=16, out_channel=16, weightnet=(12, 4),
                              num_heads=2), (16, 16, (12, 4), 2), ("xyz", "self", "norm")),
    "PCF_strided": (16, dict(in_channel=16, out_channel=32, weightnet=(12, 4),
                             num_heads=2), (16, 32, (12, 4), 2),
                    ("xyz", "fwd", "norm", "sxyz", "snorm")),
    "TransposePE": (32, dict(in_channel=32, out_channel=16, weightnet=(12, 4),
                             mlp2=(16, 16)), (32, 16, (12, 4), (16, 16)),
                    ("sxyz", "up", "snorm", "xyz", "norm")),
}
CLASSES = {"PointConv": "PointConv", "StridePE": "PointConvStridePE", "PCF": "PCFLayer",
           "TransposePE": "PointConvTransposePE"}


def _layer_args(geom, case, rng, pkg):
    n_in, _, _, keys = CASES[case]
    n_src = M if case == "TransposePE" else N
    feats = rng.normal(size=(n_src, n_in)).astype(np.float32)
    vals = [geom[("j" if pkg == "j" else "t") + k] if k in ("self", "fwd", "up")
            else geom[k] for k in keys]
    args = [vals[0], feats] + vals[1:]
    if case == "TransposePE":
        args.append(rng.normal(size=(N, 16)).astype(np.float32))  # the encoder skip
    if pkg == "j":
        return [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    return [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_layer_fused_eval_matches_pcf_tpu(geom, case, dtype):
    """Each conv layer's fused_eval path against pcf_tpu's, and (f32) the
    port's fused path against its own standard path."""
    _, jkw, tctor, _ = CASES[case]
    cls = CLASSES[case.split("_")[0]]
    jargs = _layer_args(geom, case, np.random.default_rng(1), "j")
    targs = _layer_args(geom, case, np.random.default_rng(1), "t")
    jcls = getattr(j_layers, cls)
    variables = jcls(cfg=_cfg(JConfig, j_defaults, compute_dtype=dtype), **jkw).init(
        jax.random.PRNGKey(0), *jargs, train=False)
    variables = _randomize_bn(_to_np_tree(variables), np.random.default_rng(2))
    want = jcls(cfg=_cfg(JConfig, j_defaults, fused_eval=True, compute_dtype=dtype),
                **jkw).apply(variables, *jargs, train=False)[0]

    cfg = _cfg(Config, get_default_configs, fused_eval=True, compute_dtype=dtype)
    layer = getattr(t_layers, cls)(tctor[0], tctor[1], cfg, *tctor[2:])
    load_jax_variables(layer, variables)
    layer.eval()
    with torch.no_grad():
        got, wni = layer(*targs)
    assert wni is None  # the fused path returns no WeightNet input
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        cfg.fused_eval = False
        with torch.no_grad():
            unfused = layer(*targs)[0]
        np.testing.assert_allclose(_np(got), _np(unfused), **FOLD)
    else:
        assert got.dtype == torch.bfloat16
        _close_bf16(_np(got), _np(want))


def _random_pairs(rng, dims):
    return [(rng.normal(0, ci ** -0.5, (ci, co)).astype(np.float32),
             rng.normal(0, 0.1, co).astype(np.float32)) for ci, co in zip(dims, dims[1:])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["pcf", "pcf_strided", "stride", "stride_strided",
                                  "pointconv", "transpose"])
def test_fused_layer_eval_plain_matches_pcf_tpu(geom, kind, dtype):
    """The plain version of kernel E against pcf_tpu's kernel on random
    folded weights, every branch: guided (key at k = 0 or max over K),
    pe_convs, concat_wni, W = 1, the max-pool shortcut."""
    rng = np.random.default_rng(3)
    strided = kind.endswith("strided")
    W = 1 if kind == "transpose" else 4
    Cx, Cg, Cs, O = (32 if kind == "transpose" else 7 if kind == "pointconv" else 8), 0, 0, 12
    kw = dict(use_vi=True, strided=strided)
    wn = _random_pairs(rng, [12, 8, 8, W])
    pe = gd = []
    if kind.startswith("pcf"):
        Cg, H = 8, 2
        pe = _random_pairs(rng, [12, 8])
        gd = _random_pairs(rng, [Cg + 8, 8, H])
        Ct = Cx
        kw.update(pe_on_vi=True, num_heads=H)
    elif kind == "pointconv":
        Ct = Cx + 12
        kw.update(concat_wni=True)
    else:
        pe = _random_pairs(rng, [3, 8, 4])
        Ct = Cx + 4
        kw.update(pe_on_vi=False)
    if strided:
        Cs = 16
    edges, src, ctr = (("fwd", "", "s") if strided else ("up", "s", "") if
                       kind == "transpose" else ("self", "", ""))
    n_src = M if kind == "transpose" else N
    table = rng.normal(size=(n_src, Cx + Cg + Cs)).astype(np.float32)
    geo = np.concatenate([geom[src + "xyz"], geom[src + "norm"]], -1)
    lw = rng.normal(0, (Ct * W) ** -0.5, (Ct * W, O)).astype(np.float32)
    lb = rng.normal(0, 0.1, O).astype(np.float32)
    kw.update(Cx=Cx, Cg=Cg, Cs=Cs)

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jout, jshort = j_fused_layer_eval(
        jnp.asarray(table).astype(jdt), jnp.asarray(geo), geom["j" + edges],
        jnp.asarray(geom[ctr + "xyz"]), jnp.asarray(geom[ctr + "norm"]),
        [tuple(map(jnp.asarray, p)) for p in wn], [tuple(map(jnp.asarray, p)) for p in pe],
        [tuple(map(jnp.asarray, p)) for p in gd], jnp.asarray(lw), jnp.asarray(lb),
        interpret=True, **kw)
    tdt = getattr(torch, dtype)

    def tt(x):
        return torch.from_numpy(x)

    tout, tshort = fused_layer_eval_plain(
        tt(table).to(tdt), tt(geo), geom["t" + edges], tt(geom[ctr + "xyz"]),
        tt(geom[ctr + "norm"]), [tuple(map(tt, p)) for p in wn],
        [tuple(map(tt, p)) for p in pe], [tuple(map(tt, p)) for p in gd], tt(lw), tt(lb),
        **kw)
    assert tout.dtype == tdt and tout.shape == jout.shape
    check = (lambda a, b: np.testing.assert_allclose(a, b, **F32)) \
        if dtype == "float32" else _close_bf16
    check(_np(tout), _np(jout))
    if strided:  # a max of table entries: exact in either dtype
        np.testing.assert_array_equal(_np(tshort), _np(jshort))
    else:
        assert tshort is None and jshort is None


@pytest.mark.parametrize("layout", ["LinearBN", "FusedConvLinear", "no_bn"])
def test_fold_linbn_matches_pcf_tpu(layout):
    """_fold_linbn on the same parameters and statistics; the port also folds
    the FusedConvLinear layout (kernel [in, out] at the module's top)."""
    rng = np.random.default_rng(4)
    params = {"c": {"kernel": rng.normal(size=(6, 5)).astype(np.float32),
                    "bias": rng.normal(size=5).astype(np.float32)}}
    stats = None
    if layout != "no_bn":
        params["bn"] = {"scale": rng.uniform(0.5, 2, 5).astype(np.float32),
                        "bias": rng.normal(size=5).astype(np.float32)}
        stats = {"bn": {"mean": rng.normal(size=5).astype(np.float32),
                        "var": rng.uniform(0.2, 3, 5).astype(np.float32)}}
    jw, jb = j_fe._fold_linbn(params, stats)
    if layout == "FusedConvLinear":
        mod = FusedConvLinear(6, 5)
        tree = {"params": {**params["c"], "bn": params["bn"]}, "batch_stats": stats}
    else:
        mod = LinearBN(6, 5, use_bn=layout != "no_bn")
        tree = {"params": params, "batch_stats": stats or {}}
    load_jax_variables(mod, tree)
    tw, tb = t_fe._fold_linbn(mod)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)


def test_gate_decides_as_pcf_tpu():
    """tests/test_fused_eval_gate.py's shapes: the 2cm/PTF2 caps at every
    level and edge kind, plain edges, train mode, and the key off."""
    class _L:  # pcf_tpu's gate asks the layer whether flax is initialising
        @staticmethod
        def is_initializing():
            return False

    caps = [122880, 98304, 57344, 24576, 8192]
    rng = np.random.default_rng(0)
    on, off = Config(fused_eval=True), Config(fused_eval=False)
    j_on, j_off = JConfig(fused_eval=True), JConfig(fused_eval=False)
    n_true = 0
    for lvl, m in enumerate(caps):
        for n in {m, caps[max(lvl - 1, 0)]}:
            base = (np.arange(m, dtype=np.int64) * n // m)[:, None]
            nei = np.clip(base + rng.integers(-64, 65, size=(m, 16)), 0,
                          n - 1).astype(np.int32)
            jw = j_windows(nei, tile=128, window=1664, strict=False)
            tw = WindowedEdges(*(torch.from_numpy(np.array(a)) for a in
                                 (jw.nei, jw.window_rows, jw.localT)))
            for jc, tc in ((j_on, on), (j_off, off)):
                for train in (False, True):
                    want = j_fe.fused_eval_ok(jc, _L, jw, train=train)
                    assert t_fe.fused_eval_ok(tc, tw, train) == want, (lvl, m, n, train)
                    n_true += want
            assert not t_fe.fused_eval_ok(on, tw.nei, False)
            assert not j_fe.fused_eval_ok(j_on, _L, jw.nei, train=False)
    # a tiling the kernel does not take: K = 6
    jw = j_windows(np.zeros((256, 6), np.int32), tile=128, window=128, strict=False)
    if jw is not None:
        tw = WindowedEdges(*(torch.from_numpy(np.array(a)) for a in
                             (jw.nei, jw.window_rows, jw.localT)))
        assert t_fe.fused_eval_ok(on, tw, False) == j_fe.fused_eval_ok(
            j_on, _L, jw, train=False)
    assert n_true == 9  # every level and edge kind passes in eval with the key on


def _model_cfg(cls, defaults, **kw):
    cfg = defaults(cls(), num_level=3, base_dim=8)
    cfg.update(guided_level=0, num_heads=2, resblocks=[0, 1, 1], mid_dim=[4, 4, 4],
               grid_size=GRID, num_classes=5, USE_PE=True)
    cfg.update(kw)
    return cfg


def _args(b):
    return (b.feats, list(b.points), list(b.edges_self), list(b.edges_forward),
            list(b.edges_propagate), list(b.norms))


@pytest.fixture(scope="module")
def small_model():
    """tests/test_fused_eval.py:132's model and batch, its BN statistics and
    affine parameters randomised; the port's batch from the same scene."""
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
    jmodel = JSeg(_model_cfg(JConfig, j_defaults))
    variables = jax.jit(lambda k: jmodel.init(k, *_args(jb), masks=list(jb.masks),
                                              train=False))(jax.random.PRNGKey(0))
    return jb, tb, _randomize_bn(_to_np_tree(variables), np.random.default_rng(5))


def test_model_fused_eval_matches_pcf_tpu(small_model):
    """The whole small model with fused_eval: pcf_tpu against the port on the
    valid rows, f32; every conv layer takes the kernel's plain version."""
    jb, tb, variables = small_model
    want = JSeg(_model_cfg(JConfig, j_defaults, fused_eval=True)).apply(
        variables, *_args(jb), masks=list(jb.masks), train=False)
    model = build(_model_cfg(Config, get_default_configs, fused_eval=True), device="cpu")
    load_jax_variables(model, variables)
    calls = []
    real = t_fe.fused_layer_eval
    t_fe.fused_layer_eval = lambda *a, **k: calls.append(a[0].shape) or real(*a, **k)
    try:
        with torch.no_grad():
            got = model.forward_batch(tb).numpy()
    finally:
        t_fe.fused_layer_eval = real
    assert len(calls) == 9  # PointConv, 2 + 1 + 1 res blocks, 2 strided, 2 decoders
    m = np.asarray(jb.masks[0])
    np.testing.assert_allclose(got[m], np.asarray(want)[m], **MODEL)


def test_fused_eval_folds_follow_a_train_step(small_model):
    """The folds kept on a layer go stale with the weights: a fused forward,
    one train step (AdamW moves every weight, train-mode BN every running
    statistic), then the fused forward equals the unfused one. The fused
    kernel layout (USE_PALLAS_KERNEL) folds FusedConvLinear modules."""
    _, tb, _ = small_model
    cfg = _model_cfg(Config, get_default_configs, fused_eval=True, USE_PALLAS_KERNEL=True,
                     fused_min_points=0)
    from pcf_torch.config import get_default_training_cfgs
    cfg = get_default_training_cfgs(cfg)
    state, step = build_training(cfg, device="cpu", seed=0)
    model = state.model
    model.eval()
    with torch.no_grad():
        before = model.forward_batch(tb)
    state, _ = step(state, tb, 0)
    model = state.model
    model.eval()
    with torch.no_grad():
        fused = model.forward_batch(tb)
        cfg.fused_eval = False
        unfused = model.forward_batch(tb)
    m = tb.masks[0]
    assert not torch.allclose(before[m], fused[m], **FOLD)  # the step moved the logits
    np.testing.assert_allclose(fused[m].numpy(), unfused[m].numpy(), **FOLD)


def test_fused_eval_and_flat_geom_are_ported():
    """fused_eval, flat_geom, cm_geom and spatial_axis build; spatial
    sharding (cfg.spatial_axis, or the port's sharded_points context) turns
    the whole-layer kernel off, as pcf_tpu's gate does."""
    from pcf_torch.nn.sharded import sharded_points

    for key in ("fused_eval", "flat_geom", "cm_geom", "spatial_axis"):
        build(_model_cfg(Config, get_default_configs, **{key: True}), device="cpu")
    jw = j_windows(np.zeros((256, 16), np.int32), tile=128, window=128, strict=False)
    tw = WindowedEdges(*(torch.from_numpy(np.array(a)) for a in
                         (jw.nei, jw.window_rows, jw.localT)))
    on = Config(fused_eval=True)
    assert t_fe.fused_eval_ok(on, tw, False)
    assert not t_fe.fused_eval_ok(Config(fused_eval=True, spatial_axis="space"), tw, False)

    class _L:  # pcf_tpu's gate asks the layer whether flax is initialising
        @staticmethod
        def is_initializing():
            return False

    assert j_fe.fused_eval_ok(JConfig(fused_eval=True), _L, jw, train=False)
    assert not j_fe.fused_eval_ok(JConfig(fused_eval=True, spatial_axis="space"), _L, jw,
                                  train=False)
    with sharded_points(object()):
        assert not t_fe.fused_eval_ok(on, tw, False)


def test_pcf_tpu_bf16_kernel_misreads_self_edges():
    """A fault of pcf_tpu's kernel that the port does not copy (ROADMAP.md,
    Queue 3): in bf16 it reads the geometry as a hi/lo bf16 pair, so a self
    edge's zero offset becomes the pair's residual, whose normalised
    direction is arbitrary. On coordinates that bf16 does not hold exactly,
    pcf_tpu's bf16 output moves more than 5% of the output's scale from its
    f32 output; the port, reading f32 geometry, less than 2%."""
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(N, 3)).astype(np.float32)
    nv = rng.normal(size=(N, 3))
    nv = (nv / np.linalg.norm(nv, axis=1, keepdims=True)).astype(np.float32)
    nei = np.argsort(((xyz[:, None] - xyz[None]) ** 2).sum(-1), axis=1)[:, :K]
    nei = nei.astype(np.int32)
    assert (nei[:, 0] == np.arange(N)).all()  # every point's first edge is itself
    rng = np.random.default_rng(3)
    wn = _random_pairs(rng, [12, 8, 8, 4])
    table = rng.normal(size=(N, 7)).astype(np.float32)
    lw = rng.normal(0, 76 ** -0.5, (76, 12)).astype(np.float32)
    lb = rng.normal(0, 0.1, 12).astype(np.float32)
    geo = np.concatenate([xyz, nv], -1)
    kw = dict(Cx=7, use_vi=True, concat_wni=True)
    outs = {}
    for dt in ("float32", "bfloat16"):
        outs["j", dt] = _np(j_fused_layer_eval(
            jnp.asarray(table).astype(dt), jnp.asarray(geo),
            j_windows(nei, tile=16, window=128), jnp.asarray(xyz), jnp.asarray(nv),
            [tuple(map(jnp.asarray, p)) for p in wn], [], [], jnp.asarray(lw),
            jnp.asarray(lb), interpret=True, **kw)[0])
        outs["t", dt] = _np(fused_layer_eval_plain(
            torch.from_numpy(table).to(getattr(torch, dt)), torch.from_numpy(geo),
            build_windows(nei, tile=16, window=128), torch.from_numpy(xyz),
            torch.from_numpy(nv), [tuple(map(torch.from_numpy, p)) for p in wn], [], [],
            torch.from_numpy(lw), torch.from_numpy(lb), **kw)[0])
    np.testing.assert_allclose(outs["t", "float32"], outs["j", "float32"], **F32)
    scale = np.abs(outs["j", "float32"]).max()
    assert np.abs(outs["j", "bfloat16"] - outs["j", "float32"]).max() > 0.05 * scale
    assert np.abs(outs["t", "bfloat16"] - outs["t", "float32"]).max() < 0.02 * scale
