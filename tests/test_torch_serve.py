"""The port's serving path (pcf_torch/serve) against pcf_tpu's
(tests/test_serve.py's model and scenes): artifacts exported for the CPU
with torch.export, the weights pcf_tpu's model.init(PRNGKey(0)) carried over
by load_jax_variables (BN statistics moved off their initial values, so that
every fold of the fused_eval artifact does work). pcf_tpu exports and serves
on the CPU; the port's programs call its kernels' custom operators, which run
their plain versions on CPU tensors."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pcf_tpu.config import Config as JConfig, get_default_configs as j_defaults
from pcf_tpu.core import pack_scenes as j_pack
from pcf_tpu.data import synthetic_scene as j_scene
from pcf_tpu.data.pyramid import scene_to_item as j_item
from pcf_tpu.models import PointConvFormer_Segmentation as JSeg
from pcf_tpu.serve import ServingModel as JServing, export_artifact as j_export
from pcf_tpu.serve.export import _batch_args as j_batch_args

from pcf_torch.config import Config, get_default_configs
from pcf_torch.convert import load_jax_variables
from pcf_torch.core import pack_scenes
from pcf_torch.data import scene_to_item, synthetic_scene
from pcf_torch.entry import build
from pcf_torch.ops.kernels.layer_eval import layer_eval_op
from pcf_torch.ops.kernels.pconv_fused import conv_linear_op
from pcf_torch.ops.kernels.window_resolve import resolve_flat_op, resolve_op
from pcf_torch.ops.window import WindowedEdges, build_windows
from pcf_torch.serve import ServingModel, export_artifact
from pcf_torch.serve.export import _batch_args
import pcf_torch.data.pyramid as t_pyramid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = [0.3, 0.6, 1.2]
WINDOW = dict(window_gather=True, window_tile=16, window_size=128)
KERNELS = dict(USE_PALLAS_KERNEL=True, fused_min_points=0, resolve_impl="pallas")
# the artifacts: the configuration keys beyond tests/test_serve.py's _cfg.
# The windowed one runs the fused conv kernels (the configuration of the
# card's serving phase); pcf_tpu's reference runs without them, the same
# function summed in another order
ARTIFACTS = {"plain": {}, "windowed": {**WINDOW, **KERNELS},
             "fused": {**WINDOW, "fused_eval": True}}
# the custom operators each artifact's program must call
OPS = {"plain": set(),
       "windowed": {"pcf.conv_linear.default", "pcf.window_resolve.default"},
       "fused": {"pcf.layer_eval.default"}}
JAX_TOL = dict(atol=1e-4, rtol=1e-4)
LIVE_TOL = dict(atol=1e-5, rtol=1e-5)


def _cfg(cls_config, defaults, **kw):
    cfg = defaults(cls_config(), num_level=3, base_dim=8)
    cfg.update(guided_level=0, num_heads=2, resblocks=[0, 1, 1],
               mid_dim=[4, 4, 4], grid_size=GRID, num_classes=5, USE_PE=True,
               K_self=[8] * 3, K_forward=[8] * 3, K_propagate=[8] * 3,
               bucket_multiple=128, ignore_label=-100, manual_seed=0)
    cfg.update(kw)
    return cfg


def _batches(n, seed, windowed):
    """The same scene packed by pcf_tpu and by the port."""
    kw = dict(window_tile=16, window_size=128) if windowed else {}
    jc = j_scene(n, extent=4.0, num_classes=5, seed=seed)
    tc = synthetic_scene(n, extent=4.0, num_classes=5, seed=seed)
    jb = j_pack([j_item(*jc, GRID, 8, 8, 8, rng=np.random.default_rng(seed),
                        morton=windowed)], bucket_multiple=128, **kw)
    tb = pack_scenes([scene_to_item(*tc, GRID, 8, 8, 8, rng=np.random.default_rng(seed),
                                    morton=windowed)], bucket_multiple=128, **kw)
    return jb, tb


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """pcf_tpu's model, its variables (numpy, BN statistics moved) and its
    windowed artifact; both pyramids pinned to numpy/scipy."""
    import pcf_tpu.data.pyramid as jp

    mp = pytest.MonkeyPatch()
    mp.setattr(jp, "_USE_NATIVE", False)
    mp.setattr(t_pyramid, "_USE_NATIVE", False)
    jb, _ = _batches(260, 0, True)
    cfg = _cfg(JConfig, j_defaults, **WINDOW)
    jmodel = JSeg(cfg)
    vs = jax.jit(lambda k: jmodel.init(k, *j_batch_args(jb)[:-1],
                                       masks=j_batch_args(jb)[-1], train=False))(
        jax.random.PRNGKey(0))
    vs = jax.tree_util.tree_map(np.array, dict(vs))
    rng = np.random.default_rng(1)
    for path, v in jax.tree_util.tree_flatten_with_path(vs["batch_stats"])[0]:
        node = vs["batch_stats"]
        for k in path[:-1]:
            node = node[k.key]
        leaf = path[-1].key
        node[leaf] = (rng.normal(0, 0.2, v.shape) if leaf == "mean"
                      else rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
    out = str(tmp_path_factory.mktemp("jax_artifact"))
    meta = j_export(cfg, vs, out, [jb], platforms=["cpu"])
    yield jmodel, vs, meta, JServing(out)
    mp.undo()


@pytest.fixture(scope="module")
def artifacts(ref, tmp_path_factory):
    """name -> (live port model, its batch, export meta, directory,
    ServingModel on the CPU), exported at first use."""
    made = {}

    def get(name):
        if name not in made:
            model = build(_cfg(Config, get_default_configs, **ARTIFACTS[name]), device="cpu")
            load_jax_variables(model, ref[1])
            _, tb = _batches(260, 0, name != "plain")
            out = str(tmp_path_factory.mktemp(name))
            meta = export_artifact(model.cfg, model, out, [tb], platforms=["cpu"])
            made[name] = (model, tb, meta, out, ServingModel(out, device="cpu"))
        return made[name]

    return get


@pytest.mark.parametrize("name", ["plain", "windowed"])
def test_served_logits_match_pcf_tpu_and_the_live_forward(ref, artifacts, name):
    jmodel, vs, _, _ = ref
    model, tb, meta, _, serving = artifacts(name)
    assert len(meta["buckets"]) == 1
    jb, _ = _batches(260, 0, name != "plain")
    got = serving.predict_packed(tb).numpy()
    apply = jax.jit(lambda v, *a, masks: jmodel.apply(v, *a, masks=masks, train=False))
    want = np.asarray(apply(vs, *j_batch_args(jb)[:-1], masks=j_batch_args(jb)[-1]),
                      np.float32)
    with torch.no_grad():
        live = model.forward_batch(tb).numpy()
    mask = tb.masks[0].numpy()
    np.testing.assert_allclose(got[mask], want[mask], **JAX_TOL)
    np.testing.assert_allclose(got[mask], live[mask], **LIVE_TOL)


def test_predict_scene_matches_pcf_tpu(ref, artifacts):
    jserving = ref[3]
    serving = artifacts("windowed")[4]
    coord, norm, feats, _ = synthetic_scene(240, extent=4.0, num_classes=5, seed=2)
    jc = j_scene(240, extent=4.0, num_classes=5, seed=2)
    labels, probs = serving.predict_scene(coord, norm, feats, rng=np.random.default_rng(3))
    jlabels, jprobs = jserving.predict_scene(*jc[:3], rng=np.random.default_rng(3))
    assert labels.shape == (240,) and probs.shape == (240, 5)
    np.testing.assert_allclose(probs, jprobs, atol=1e-4)
    top2 = np.sort(jprobs, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-3
    np.testing.assert_array_equal(labels[clear], np.asarray(jlabels)[clear])
    assert set(serving.last_split) == {"host", "device", "copy", "post"}


def test_meta_is_pcf_tpus_plus_the_platform_files(ref, artifacts):
    jmeta = json.loads(json.dumps(ref[2]))
    meta = artifacts("windowed")[2]
    assert set(meta) == set(jmeta)
    assert meta["window"] == jmeta["window"] == {"tile": 16, "sizes": None, "size": 128}
    for key in set(meta) - {"buckets", "cfg"}:
        assert meta[key] == jmeta[key], key
    assert set(meta["cfg"]) >= set(jmeta["cfg"])
    for b, jbk in zip(meta["buckets"], jmeta["buckets"], strict=True):
        assert set(b) - set(jbk) == {"files"} and set(jbk) <= set(b)
        assert b["level_caps"] == jbk["level_caps"]
        assert b["files"] == {"cpu": "bucket_0.cpu.pt2"} and b["file"] == b["files"]["cpu"]
    with open(os.path.join(artifacts("windowed")[3], "meta.json")) as f:
        assert json.load(f) == meta


def test_calling_convention_pins_windowed_edges_as_three_tensors(artifacts):
    tb = artifacts("windowed")[1]
    args = _batch_args(tb)
    assert len(args) == 7 and args[0] is tb.feats
    for got, edges in zip(args[2:5], (tb.edges_self, tb.edges_forward, tb.edges_propagate)):
        assert all(isinstance(e, WindowedEdges) for e in edges)
        assert [tuple(g) for g in got] == [(e.nei, e.window_rows, e.localT) for e in edges]
    plain = _batch_args(artifacts("plain")[1])
    assert all(isinstance(e, torch.Tensor) for es in plain[2:5] for e in es)


def test_unknown_bucket_and_oversized_scene_are_refused(artifacts):
    serving = artifacts("plain")[4]
    _, big = _batches(2000, 1, False)
    assert tuple(int(p.shape[0]) for p in big.points) not in serving.bucket_keys
    with pytest.raises(KeyError, match="not in artifact"):
        serving.predict_packed(big)
    coord, norm, feats, _ = synthetic_scene(2000, extent=4.0, num_classes=5, seed=1)
    with pytest.raises(ValueError, match="re-export with a scene this large"):
        serving.predict_scene(coord, norm, feats)


@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_programs_hold_no_weights_and_call_the_kernels(artifacts, name):
    model, tb, meta, out, serving = artifacts(name)
    (program,) = serving.programs.values()  # loaded from bucket_0.cpu.pt2
    assert not program.state_dict and not program.constants
    called = {str(n.target) for n in program.graph.nodes
              if n.op == "call_function" and str(n.target).startswith("pcf.")}
    assert called == OPS[name]
    with torch.no_grad():
        live = model.forward_batch(tb)
    mask = tb.masks[0]
    torch.testing.assert_close(serving.predict_packed(tb)[mask], live[mask], **LIVE_TOL)


_SERVE_ALONE = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
import pcf_torch.data.pyramid as pyramid
pyramid._USE_NATIVE = False
from pcf_torch.serve import ServingModel
from pcf_torch.data.synthetic import synthetic_scene
serving = ServingModel({out!r}, device="cpu")
coord, norm, feats, _ = synthetic_scene(240, extent=4.0, num_classes=5, seed=2)
labels, probs = serving.predict_scene(coord, norm, feats, rng=np.random.default_rng(3))
assert labels.shape == (240,)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "pcf_tpu")
             or n.startswith(("pcf_torch.models", "pcf_torch.nn")))
print("loaded", bad)
"""


def test_serving_loads_no_model_code(artifacts):
    out = artifacts("windowed")[3]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _SERVE_ALONE.format(root=ROOT, out=out)],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split("\n")[-2] == "loaded []", r.stdout


def _op_cases():
    """(op, args) of each custom operator at small shapes, CPU tensors."""
    g = torch.Generator().manual_seed(0)
    N, M, K, C = 64, 32, 8, 6
    nei = torch.randint(0, N, (M, K), generator=g, dtype=torch.int32)
    e = build_windows(nei.numpy(), tile=16, window=128)
    table = torch.randn(N, C, generator=g)
    feats, W, O, H, P = torch.randn(N, C, generator=g), 4, 5, 2, 3
    wts = torch.randn(M, K, W, generator=g)
    guided = (True, feats, e.nei, e.window_rows, e.localT, torch.randn(M, K, H, generator=g),
              wts, torch.randn(C * W, O, generator=g), torch.randn(O, generator=g), True)
    pe = (False, feats, nei, None, None, torch.randn(M, K, P, generator=g), wts,
          torch.randn((C + P) * W, O, generator=g), torch.randn(O, generator=g), False)
    # kernel E: a strided PCF layer, 12-d VI into a WeightNet [12->4->W], PE
    # [12->3], guidance over [Cg | PE] -> H heads
    Cx, Cg, Cs, Cpe = 4, 2, 3, 3
    mlp = [torch.randn(12, 4, generator=g), torch.randn(4, generator=g),
           torch.randn(4, W, generator=g), torch.randn(W, generator=g),
           torch.randn(12, Cpe, generator=g), torch.randn(Cpe, generator=g),
           torch.randn(Cg + Cpe, H, generator=g), torch.randn(H, generator=g)]
    layer = (torch.randn(N, Cx + Cg + Cs, generator=g), torch.randn(N, 6, generator=g),
             e.nei, e.window_rows, e.localT, torch.randn(M, 3, generator=g),
             torch.randn(M, 3, generator=g), mlp, [2, 1, 1],
             torch.randn(Cx * W, O, generator=g), torch.randn(O, generator=g),
             Cx, Cg, Cs, True, True, False, True, H)
    return {"window_resolve": (resolve_op, (table, e.window_rows, e.localT)),
            "window_resolve_flat": (resolve_flat_op, (table, e.window_rows, e.localT, K)),
            "conv_linear_guided": (conv_linear_op, guided),
            "conv_linear_pe": (conv_linear_op, pe),
            "layer_eval": (layer_eval_op, layer)}


@pytest.mark.parametrize("case", list(_op_cases()))
def test_custom_op_fake_matches_the_real_output(case):
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args = _op_cases()[case]
    real = op(*args)
    mode = FakeTensorMode()

    def fake(x):
        if isinstance(x, torch.Tensor):
            return mode.from_tensor(x)
        return [fake(v) for v in x] if isinstance(x, list) else x

    with mode:
        faked = op(*[fake(a) for a in args])
    real, faked = ((real,), (faked,)) if isinstance(real, torch.Tensor) else (real, faked)
    assert len(real) == len(faked)
    for r, f in zip(real, faked):
        assert (f.shape, f.dtype, f.device) == (r.shape, r.dtype, r.device)
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))
