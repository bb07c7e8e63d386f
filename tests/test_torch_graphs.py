"""The host side of the port's compiled steps (parallel/graphs.py), held
against pcf_tpu on the CPU, where the steps run their eager bodies:

  (a) PackedPyramid.signature() splits batches exactly where pcf_tpu's
      jax.jit of make_eval_step grows its cache;
  (b) PackedPyramid.copy_ copies a batch of the same signature and refuses
      another;
  (c) the fused optimizers with a tensor learning rate follow pcf_tpu's
      optax updates;
  (d) dropout and DropPath through the step's one generator and the remat
      recompute's recorded draws: the eager body against itself without
      remat, and against pcf_tpu's step;
  (e) the staleness rule: the derived-weight caches make their value again
      after derived.weights_written, which every train step and optimizer
      update calls, though no operator wrote the tensors; an eval step's
      graphs are dropped exactly then.
Sizes: 2 scenes x 1500 points, bucket 512, K 8, window tile 16.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcf_tpu.config import Config as JConfig, get_default_configs as j_defaults
from pcf_tpu.core import pack_scenes as j_pack
from pcf_tpu.data import synthetic_scene as j_scene
from pcf_tpu.data.pyramid import scene_to_item as j_item
from pcf_tpu.models import PointConvFormer_Segmentation as JSeg

from pcf_torch.convert import load_jax_variables
from pcf_torch.core import pack_scenes
from pcf_torch.data import scene_to_item, synthetic_scene
from pcf_torch.entry import build_training
from pcf_torch.ops.kernels import derived
from pcf_torch.ops.kernels.layer_eval import packed_weights
from pcf_torch.ops.kernels.pconv_fused import _bf16_weight, _training
import pcf_torch.parallel.graphs as graphs_mod
from pcf_torch.parallel.graphs import Compiled, StepGraphs
from pcf_torch.parallel.mesh import make_eager_train_step, make_train_step
from pcf_torch.train.state import make_optimizer
import pcf_torch.data.pyramid as t_pyramid

from test_torch_kernel_host import _layer
from test_torch_train import _jcfg, _tcfg
from test_torch_train import batch  # noqa: F401  (fixture)
from test_torch_train_step import (_assert_grads_close, _jax_loss_and_grads,  # noqa: F401
                                   monkeypatch_module, pair, smooth_relus)

GRID = [0.1, 0.2, 0.4]
WINDOWS = (128, 128, 128)


def _scene_pair(seed):
    """The scene of `seed` as each package's pipeline makes it (K = 8)."""
    c, n, f, l = j_scene(1500, extent=3.0, num_classes=5, seed=seed)
    jit = j_item(c, n, f, l, GRID, 8, 8, 8, rng=np.random.default_rng(seed), morton=True)
    c, n, f, l = synthetic_scene(1500, extent=3.0, num_classes=5, seed=seed)
    tit = scene_to_item(c, n, f, l, GRID, 8, 8, 8, rng=np.random.default_rng(seed),
                        morton=True)
    return jit, tit


def _caps(scenes):
    sizes = [sum(-(-s["point_list"][lvl].shape[0] // 16) * 16 for s in scenes)
             for lvl in range(len(GRID))]
    return [-(-s // 512) * 512 for s in sizes]


@pytest.fixture(scope="module")
def batches(monkeypatch_module):
    """Four batches in both packages: seeds (0, 1) and (2, 3) packed to the
    same caps and windows, then (0, 1) with a larger level-0 cap, then with
    larger windows."""
    import pcf_tpu.data.pyramid as jp

    monkeypatch_module.setattr(jp, "_USE_NATIVE", False)
    monkeypatch_module.setattr(t_pyramid, "_USE_NATIVE", False)
    pairs = {s: _scene_pair(s) for s in range(4)}
    caps = [max(a, b) for a, b in zip(_caps([pairs[s][1] for s in (0, 1)]),
                                      _caps([pairs[s][1] for s in (2, 3)]))]
    plans = [((0, 1), caps, WINDOWS), ((2, 3), caps, WINDOWS),
             ((0, 1), [caps[0] + 512] + caps[1:], WINDOWS), ((0, 1), caps, (256, 128, 256))]
    out = []
    for seeds, level_caps, windows in plans:
        kw = dict(level_caps=level_caps, window_tile=16, window_sizes=windows)
        out.append((j_pack([pairs[s][0] for s in seeds], **kw),
                    pack_scenes([pairs[s][1] for s in seeds], **kw)))
    return out


def _args(b):
    return (b.feats, list(b.points), list(b.edges_self), list(b.edges_forward),
            list(b.edges_propagate), list(b.norms))


def test_signature_splits_where_jax_jit_retraces(batches):
    """(a) pcf_tpu's jitted eval step compiles anew for a batch exactly when
    the port's signature of that batch is new."""
    from pcf_tpu.parallel import make_eval_step as j_make_eval_step
    from pcf_tpu.train.state import create_train_state as j_state
    from pcf_tpu.train.state import make_optimizer as j_make_optimizer

    jcfg = j_defaults(JConfig(), num_level=3, base_dim=8)
    jcfg.update(guided_level=0, num_heads=2, resblocks=[0, 1, 1], mid_dim=[4, 4, 4],
                grid_size=GRID, num_classes=5, USE_PE=True, window_gather=True)
    from pcf_tpu.config import get_default_training_cfgs as j_train_defaults

    jcfg = j_train_defaults(jcfg)
    jcfg.update(milestones=[100], warmup_epochs=1)
    jmodel = JSeg(jcfg)
    jb0 = batches[0][0]
    variables = jax.jit(lambda k: jmodel.init(k, *_args(jb0), masks=list(jb0.masks),
                                              train=False))(jax.random.PRNGKey(0))
    state = j_state(variables, j_make_optimizer(jcfg)[0])
    ev = j_make_eval_step(jmodel, jcfg)
    seen, grew, new = [], [], []
    for jb, tb in batches:
        before = ev._cache_size()
        jax.block_until_ready(ev(state, jb))
        grew.append(ev._cache_size() > before)
        new.append(tb.signature() not in seen)
        seen.append(tb.signature())
    assert new == [True, False, True, True]
    assert grew == new


def test_copy_takes_a_batch_of_the_same_signature(batches):
    """(b) copy_ gives tensors equal to the source's, in the destination's
    own storage, and raises on another signature."""
    (_, b0), (_, b1), (_, b2), (_, b3) = batches
    dst = b1.clone()
    ptrs = [t.data_ptr() for t in dst.tensors()]
    assert dst.copy_(b0) is dst
    assert [t.data_ptr() for t in dst.tensors()] == ptrs
    for got, want in zip(dst.tensors(), b0.tensors()):
        assert torch.equal(got, want)
    assert not all(torch.equal(a, b) for a, b in zip(b1.tensors(), b0.tensors()))
    for other in (b2, b3, b0.to("cpu", torch.float64)):
        with pytest.raises(ValueError, match="signature"):
            dst.copy_(other)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("opt_name", ["SGD", "Adam", "AdamW"])
def test_fused_optimizers_with_a_tensor_lr_match_optax(opt_name, accum):
    """(c) torch's fused SGD / Adam / AdamW reading the LR from a 0-d tensor
    that `begin` fills: three updates against pcf_tpu's optax ones, at
    tests/test_torch_train.py's tolerance."""
    from pcf_tpu.train.state import make_optimizer as j_make_optimizer

    kw = dict(optimizer=opt_name, learning_rate=0.05, decay_rate=0.01, adamw_decay=0.05,
              milestones=[1, 2], gamma=0.5, warmup_epochs=1, warmup_ratio=1e-2,
              accum_iter=accum, grad_clip_norm=1.0)
    rng = np.random.default_rng(7)
    w0 = rng.normal(size=(6, 4)).astype(np.float32)
    grads = [rng.normal(size=(6, 4)).astype(np.float32) * s for s in (0.5, 3.0, 1.5)]

    tx, _ = j_make_optimizer(_jcfg(**kw), iter_per_epoch=1)
    params = {"w": jnp.asarray(w0)}
    opt_state = tx.init(params)
    ttx, _ = make_optimizer(_tcfg(**kw), iter_per_epoch=1)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    ttx.init([tw])
    assert ttx.lr.dim() == 0 and ttx.inner.defaults["fused"]
    assert all(g["lr"] is ttx.lr for g in ttx.inner.param_groups)
    if opt_name != "SGD":
        assert ttx.inner.defaults["capturable"]
    for g in grads:
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        tw.grad = torch.from_numpy(g.copy())
        ttx.update()
        np.testing.assert_allclose(tw.detach().numpy(), np.asarray(params["w"]), atol=1e-6)


def test_optimizer_loads_in_place():
    """load_state_dict keeps the LR tensor and the state tensors a captured
    step reads, with the loaded values."""
    ttx, _ = make_optimizer(_tcfg(optimizer="AdamW"), iter_per_epoch=1)
    tw = torch.nn.Parameter(torch.ones(3, 2))
    ttx.init([tw])
    for _ in range(2):
        tw.grad = torch.full((3, 2), 0.5)
        ttx.update()
    saved = {k: v.clone() for k, v in ttx.inner.state[tw].items()}
    snapshot = copy.deepcopy(ttx.state_dict())  # as a checkpoint holds it
    held = {k: v.data_ptr() for k, v in ttx.inner.state[tw].items()}
    tw.grad = torch.full((3, 2), 2.0)
    ttx.update()
    ttx.load_state_dict(snapshot)
    assert ttx.count == 2 and all(g["lr"] is ttx.lr for g in ttx.inner.param_groups)
    for k, v in ttx.inner.state[tw].items():
        assert v.data_ptr() == held[k] and torch.equal(v, saved[k]), k


def test_optimizer_refuses_another_optimizers_state():
    """The state of another optimizer or accumulation raises ValueError (the
    trainer's cue for its warm start) and loads nothing."""
    tw = torch.nn.Parameter(torch.ones(3, 2))
    tx, _ = make_optimizer(_tcfg(optimizer="AdamW"), iter_per_epoch=1)
    tx.init([tw])
    for other in (dict(optimizer="SGD"), dict(optimizer="AdamW", accum_iter=2)):
        otx, _ = make_optimizer(_tcfg(**other), iter_per_epoch=1)
        otx.init([torch.nn.Parameter(torch.ones(3, 2))])
        otx.count = 5
        with pytest.raises(ValueError, match="does not fit AdamW"):
            tx.load_state_dict(otx.state_dict())
        assert tx.count == 0


def test_graph_pools_kept_within_the_budget(monkeypatch):
    """After a capture, the least recently used graphs (a replay makes a
    graph the most recent) are dropped until the pools fit the budget; the
    graph just captured always stays."""
    monkeypatch.setattr(graphs_mod, "POOL_BUDGET_BYTES", 7)
    graphs = StepGraphs()
    assert graphs.lookup("p", "a", 0) is None
    for sig in ("a", "b"):
        graphs.entries[("p", sig)] = Compiled(None, None, None, (), 0.0, 3, 0)
    assert graphs.lookup("p", "a", 0) is not None  # used: now after b
    graphs.entries[("p", "c")] = Compiled(None, None, None, (), 0.0, 3, 0)
    graphs._fit_budget(("p", "c"), None)
    assert list(graphs.entries) == [("p", "a"), ("p", "c")] and graphs.evictions == 1
    assert graphs.pool_bytes() == 6
    monkeypatch.setattr(graphs_mod, "POOL_BUDGET_BYTES", 1)
    graphs._fit_budget(("p", "c"), None)
    assert list(graphs.entries) == [("p", "c")] and graphs.evictions == 2


def _step_values(cfg, batch, seed, step_fn=make_eager_train_step):
    state, _ = build_training(cfg, device="cpu")
    state, metrics = step_fn(cfg)(state, batch, seed)
    return metrics["loss"], {k: p.grad for k, p in state.model.named_parameters()}


def test_dropout_draws_replay_in_the_remat_recompute(batch):  # noqa: F811
    """(d) dropout and DropPath at 0.1: with remat_blocks the recompute uses
    the masks its forward drew, so loss and every gradient equal those of
    the step without remat, bit for bit; the captured route's step (its
    eager body on the CPU) gives the same; the step function's one generator
    gives one step per seed."""
    rates = dict(dropout_rate=0.1, drop_path_rate=0.1, dropout_fc=0.1)
    loss, grads = _step_values(_tcfg(remat_blocks=True, **rates), batch, 5)
    for cfg, fn in ((_tcfg(remat_blocks=False, **rates), make_eager_train_step),
                    (_tcfg(remat_blocks=True, **rates), make_train_step)):
        other_loss, other = _step_values(cfg, batch, 5, fn)
        assert torch.equal(loss, other_loss)
        for k, g in grads.items():
            assert torch.equal(g, other[k]), k
    no_drop, _ = _step_values(_tcfg(remat_blocks=True), batch, 5)
    assert loss != no_drop
    state, _ = build_training(_tcfg(**rates), device="cpu")
    step = make_eager_train_step(_tcfg(**rates))
    losses = [float(step(state, batch, s)[1]["loss"]) for s in (5, 5, 6)]
    state2, _ = build_training(_tcfg(**rates), device="cpu")
    assert [float(step(state2, batch, s)[1]["loss"]) for s in (5, 5, 6)] == losses


def test_eager_body_matches_pcf_tpu_step(pair, smooth_relus):  # noqa: F811
    """(d) the eager body with remat_blocks (the generator path and the
    recorded draws, here with nothing to draw) against pcf_tpu's train step,
    as tests/test_torch_train_step.py holds the step: every ReLU smooth in
    both packages, the loss within 1e-5 relative and every gradient within
    5e-3 of its largest entry."""
    _, tb, variables = pair
    want_loss, want_grads = _jax_loss_and_grads(pair, train=True)
    cfg = _tcfg(remat_blocks=True)
    state, _ = build_training(cfg, device="cpu")
    load_jax_variables(state.model, variables)
    state, metrics = make_eager_train_step(cfg)(state, tb, 0)
    assert abs(float(metrics["loss"]) - want_loss) <= 1e-5 * abs(want_loss)
    _assert_grads_close({k: p.grad.numpy() for k, p in state.model.named_parameters()},
                        want_grads)


def test_weights_written_renews_every_derived_weight():
    """(e) after derived.weights_written, the bf16 L copy, kernel E's packed
    weights and the BN folds are made again though no operator wrote their
    tensors; until then each is kept; a forward that builds L's gradient
    rounds it afresh."""
    lw = torch.nn.Parameter(torch.randn(24, 13))
    wn, pe, gd, plw, plb = _layer(2)
    layer = torch.nn.Module()
    layer.linear = torch.nn.Linear(4, 3)
    fold = lambda: [layer.linear.weight.t().clone()]  # noqa: E731
    from pcf_torch.nn.fused_eval import _folded

    def derive():
        return (_bf16_weight(lw, True), packed_weights(wn, pe, gd, plw, plb, True),
                _folded(layer, ("linear",), fold))

    with torch.no_grad():
        first, again = derive(), derive()
        assert all(a is b for a, b in zip(first, again))
        derived.weights_written([lw, plw, layer.linear.weight])
        renewed = derive()
    assert all(a is not b for a, b in zip(first, renewed))
    assert torch.equal(renewed[0], first[0]) and torch.equal(renewed[1].params, first[1].params)
    assert torch.equal(renewed[2][0], first[2][0])
    # a forward that builds L's gradient rounds afresh: in a captured train
    # step L changes at every replay
    assert _bf16_weight(lw, False) is not _bf16_weight(lw, False)
    assert _training(lw)
    with torch.no_grad():
        assert not _training(lw)


def test_steps_updates_loads_and_moves_change_the_stamp(batch):  # noqa: F811
    """The eval graphs' stamp of a model (derived.stamp of its parameters and
    buffers) changes with a train step, an optimizer update, a train-mode
    forward, load_state_dict and a dtype move; StepGraphs drops a program's
    graphs when its stamp changed, and only that program's."""
    state, step = build_training(_tcfg(), device="cpu")
    model = state.model

    def moved(fn):
        before = derived.stamp(derived.model_tensors(model))
        fn()
        return derived.stamp(derived.model_tensors(model)) != before

    def update():
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        state.tx.update()

    def train_forward():
        model.train()
        with torch.no_grad():
            model.forward_batch(batch)

    assert moved(lambda: step(state, batch, 0))
    assert moved(update)
    assert moved(train_forward)
    assert moved(lambda: model.load_state_dict(model.state_dict()))
    assert moved(lambda: model.to(torch.float64))
    assert sorted(map(id, derived.model_tensors(model))) == sorted(
        map(id, [*model.parameters(), *model.buffers()]))

    def eval_forward():
        model.eval()
        with torch.no_grad():
            model.forward_batch(batch.to("cpu", torch.float64))

    assert not moved(eval_forward)

    class Graph:
        replays = 0

        def replay(self):
            self.replays += 1

    graphs, graph = StepGraphs(), Graph()
    assert graphs.lookup("p", "sig", "s0") is None and graphs.lookup("q", "sig", "t0") is None
    for program in ("p", "q"):
        graphs.entries[(program, "sig")] = Compiled(graph, batch.clone(), program, (), 0.0, 0, 0)
    assert graphs.run("p", "sig", "s0", None, batch, torch.device("cpu")) == ("p", True)
    assert graph.replays == 1 and graphs.replays == 1
    assert graphs.lookup("p", "sig", "s1") is None
    assert graphs.lookup("q", "sig", "t0") is not None
