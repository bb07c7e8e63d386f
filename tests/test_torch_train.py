"""pcf_torch's training slice against pcf_tpu's on the same numpy inputs:
loss, IoU histograms, every LR schedule family and the optimizer / clip /
accumulation recursion (the whole train step is tests/test_torch_train_step.py).
Also the port's own contracts on a small windowed model: remat leaves
gradients and BN statistics as they are, the resolve's backward runs once
per gradient-carrying resolve, the bf16 path tracks f32, dropout draws from
the step's generator, checkpoints round-trip, and the loops defer metrics."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcf_tpu.config import (Config as JConfig, get_default_configs as j_defaults,
                            get_default_training_cfgs as j_train_defaults)
from pcf_tpu.train import lr as j_lr
from pcf_tpu.train.loss import cross_entropy_loss as j_ce
from pcf_tpu.train.metrics import intersection_and_union as j_iou

from chip_smoke import graph_scatters
from pcf_torch.config import Config, get_default_configs, get_default_training_cfgs
from pcf_torch.core import pack_scenes
from pcf_torch.data import scene_to_item, synthetic_scene
from pcf_torch.entry import build, build_training
from pcf_torch.train import lr as t_lr
from pcf_torch.train.loss import cross_entropy_loss
from pcf_torch.train.metrics import intersection_and_union
from pcf_torch.train.state import TrainState, make_optimizer

GRID = [0.3, 0.6, 1.2]


def _cfg(cls_config, defaults, train_defaults, **kw):
    cfg = train_defaults(defaults(cls_config(), num_level=3, base_dim=8))
    cfg.update(guided_level=0, num_heads=2, resblocks=[0, 1, 1], mid_dim=[4, 4, 4],
               grid_size=GRID, num_classes=5, USE_PE=True, USE_PALLAS_KERNEL=True,
               fused_min_points=0, resolve_impl="pallas", scheduler="MultiStepWithWarmup",
               milestones=[100], warmup_epochs=1, learning_rate=0.02)
    cfg.update(kw)
    return cfg


def _jcfg(**kw):
    return _cfg(JConfig, j_defaults, j_train_defaults, **kw)


def _tcfg(**kw):
    return _cfg(Config, get_default_configs, get_default_training_cfgs, **kw)


@pytest.fixture(scope="module")
def batch():
    """tests/test_torch_model.py's windowed batch (pcf_torch's pipeline)."""
    c, n, f, l = synthetic_scene(250, extent=4.0, num_classes=5, seed=3)
    return pack_scenes([scene_to_item(c, n, f, l, GRID, 8, 8, 8,
                                      rng=np.random.default_rng(3), morton=True)],
                       bucket_multiple=128, window_tile=16, window_size=128)


# ---- loss, metrics, schedules --------------------------------------------

@pytest.mark.parametrize("smoothing,weighted", [(0.0, False), (0.1, True), (0.2, False)])
def test_cross_entropy_matches_pcf_tpu(smoothing, weighted):
    rng = np.random.default_rng(40)
    logits = rng.standard_normal((200, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, 200).astype(np.int32)
    labels[::9] = -100
    mask = rng.uniform(size=200) < 0.9
    cw = rng.uniform(0.5, 2.0, 7).astype(np.float32) if weighted else None
    want, wn = j_ce(jnp.asarray(logits), jnp.asarray(labels), mask=jnp.asarray(mask),
                    class_weights=None if cw is None else jnp.asarray(cw),
                    label_smoothing=smoothing)
    got, n = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                mask=torch.from_numpy(mask),
                                class_weights=None if cw is None else torch.from_numpy(cw),
                                label_smoothing=smoothing)
    assert int(n) == int(wn)
    assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))
    # every point ignored: loss 0, no division by zero
    z, n0 = cross_entropy_loss(torch.from_numpy(logits), torch.full((200,), -100))
    assert float(z) == 0.0 and int(n0) == 0


def test_intersection_and_union_matches_pcf_tpu():
    rng = np.random.default_rng(41)
    pred = rng.integers(0, 6, 500).astype(np.int32)
    target = rng.integers(0, 6, 500).astype(np.int32)
    target[::7] = -100
    mask = rng.uniform(size=500) < 0.8
    want = j_iou(jnp.asarray(pred), jnp.asarray(target), 6, mask=jnp.asarray(mask))
    got = intersection_and_union(torch.from_numpy(pred), torch.from_numpy(target), 6,
                                 mask=torch.from_numpy(mask))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


_SCHEDULES = {
    "multistep": lambda m: m.multistep_with_warmup(0.1, [10, 30], gamma=0.3,
                                                   warmup_iters=8, warmup_ratio=1e-3),
    "cosine": lambda m: m.cosine_annealing_warmup_restarts(12, 0.1, min_lr=1e-4,
                                                           warmup_steps=3, gamma=0.7,
                                                           cycle_mult=1.5),
    "poly_warmup": lambda m: m.poly_with_warmup(0.1, 60, warmup_iters=7),
    "poly": lambda m: m.poly(0.1, 60),
    "squared": lambda m: m.squared(0.1, 60),
    "exp": lambda m: m.exp(0.1, 9),
    "step": lambda m: m.step_lr(0.1, 11),
    "onecycle": lambda m: m.onecycle(0.1, 40),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_schedule_matches_pcf_tpu(name):
    want, got = _SCHEDULES[name](j_lr), _SCHEDULES[name](t_lr)
    for step in range(50):
        assert abs(got(step) - float(want(step))) <= 1e-6, (name, step)


@pytest.mark.parametrize("scheduler", ["MultiStepWithWarmup", "CosineAnnealingWarmupRestarts",
                                       "Constant"])
def test_schedule_from_config_matches_pcf_tpu(scheduler):
    kw = dict(scheduler=scheduler, milestones=[2, 4], total_epoches=8, warmup_epochs=1)
    want = j_lr.from_config(_jcfg(**kw), 6)
    got = t_lr.from_config(_tcfg(**kw), 6)
    for step in range(50):
        assert abs(got(step) - float(want(step))) <= 1e-6, (scheduler, step)


# ---- optimizer recursion ---------------------------------------------------

@pytest.mark.parametrize("opt_name,accum", [("SGD", 1), ("SGD", 3), ("Adam", 3),
                                            ("AdamW", 2), ("AdamW", 5)])
def test_optimizer_recursion_matches_pcf_tpu(opt_name, accum):
    """tests/test_train_parity.py's recursion, held against
    pcf_tpu.train.state.make_optimizer: synthetic gradients, 18 micro-steps,
    clipping firing on partial sums, the LR advancing per micro-step."""
    from pcf_tpu.train.state import make_optimizer as j_make_optimizer

    kw = dict(optimizer=opt_name, learning_rate=0.05, decay_rate=0.01, adamw_decay=0.05,
              milestones=[1, 2], gamma=0.5, warmup_epochs=1, warmup_ratio=1e-2,
              accum_iter=accum, grad_clip_norm=1.0)
    rng = np.random.default_rng(3)
    w0 = rng.normal(size=(6, 4)).astype(np.float32)
    # grad scale chosen so ||g/accum|| straddles the clip threshold
    grads = [rng.normal(size=(6, 4)).astype(np.float32) * rng.uniform(0.5, 3.0)
             for _ in range(18)]
    assert any(np.sqrt((g ** 2).sum()) / accum > 1.0 for g in grads)

    tx, _ = j_make_optimizer(_jcfg(**kw), iter_per_epoch=5)
    params = {"w": jnp.asarray(w0)}
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)

    ttx, _ = make_optimizer(_tcfg(**kw), iter_per_epoch=5)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    ttx.init([tw])
    for g in grads:
        tw.grad = torch.from_numpy(g.copy())
        ttx.update()
        assert torch.equal(tw.grad, torch.from_numpy(g))  # the raw gradient stays
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(params["w"]), atol=1e-6)


# ---- the port's own contracts ------------------------------------------

def test_remat_blocks_changes_no_gradient_or_statistic(batch):
    """remat_blocks recomputes each residual block in the backward; the
    recompute must not move the BN running statistics a second time."""
    tb = batch
    out = {}
    for remat in (False, True):
        state, step = build_training(_tcfg(remat_blocks=remat), device="cpu")
        state, _ = step(state, tb, 0)
        out[remat] = ({k: p.grad for k, p in state.model.named_parameters()},
                      state.model.state_dict())
    for a, b in zip(out[False], out[True]):
        for key in a:
            assert torch.equal(a[key], b[key]), key


def test_resolve_backward_runs_once_per_gradient_carrying_resolve(batch, monkeypatch):
    """The resolve's backward (kernel D, here its plain version) runs once for
    every resolve in the step's graph whose table needs a gradient, plus one
    for each window-mode fused layer whose features need one (its backward's
    recompute gathers through the resolve), and not again for the remat
    recompute. chip_smoke.py holds the card's launches to the same count."""
    import pcf_torch.ops.kernels.window_resolve as wr_mod
    import pcf_torch.parallel.mesh as mesh_mod
    from pcf_torch.ops.window import WindowedEdges

    tb = batch
    scatters, expected = [], []
    real_scatter, real_loss = wr_mod.window_scatter, mesh_mod.cross_entropy_loss

    def counting_scatter(*a):
        scatters.append(a)
        return real_scatter(*a)

    def counting_loss(logits, *a, **kw):
        expected.append(graph_scatters(logits.grad_fn, WindowedEdges))
        return real_loss(logits, *a, **kw)

    monkeypatch.setattr(wr_mod, "window_scatter", counting_scatter)
    monkeypatch.setattr(mesh_mod, "cross_entropy_loss", counting_loss)
    state, step = build_training(_tcfg(), device="cpu")
    step(state, tb, 0)
    assert expected[0] > 0 and len(scatters) == expected[0]


def test_bf16_forward_tracks_f32_and_gradients_are_finite(batch):
    """tests/test_bf16.py's contract for the port: parameters stay f32, the
    bf16 logits track the f32 ones (0.15 of the scale, 90% argmax
    agreement), and the bf16 step's gradients are finite f32."""
    tb = batch
    m32 = build(_tcfg(), device="cpu")
    m16 = build(_tcfg(compute_dtype="bfloat16"), device="cpu")
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    with torch.no_grad():
        m32.train()
        m32.forward_batch(tb)  # calibrate BN, as test_bf16.py
        m32.eval()
        m16.load_state_dict(m32.state_dict())
        m16.eval()
        a = m32.forward_batch(tb)[tb.masks[0]]
        c = m16.forward_batch(tb).float()[tb.masks[0]]
    assert torch.isfinite(c).all()
    assert (a - c).abs().max() / max(a.abs().max(), 1.0) < 0.15
    assert (a.argmax(-1) == c.argmax(-1)).float().mean() > 0.9

    state, step = build_training(_tcfg(compute_dtype="bfloat16"), device="cpu")
    state, metrics = step(state, tb, 0)
    assert torch.isfinite(metrics["loss"])
    for key, p in state.model.named_parameters():
        assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), key


def test_dropout_draws_from_the_step_generator(batch):
    """With dropout and DropPath on, one seed gives one step, another seed
    another, and a forward in training without a generator raises."""
    tb = batch
    cfg = _tcfg(dropout_rate=0.3, drop_path_rate=0.3, dropout_fc=0.2)
    losses = []
    for seed in (5, 5, 6):
        state, step = build_training(cfg, device="cpu")
        losses.append(float(step(state, tb, seed)[1]["loss"]))
    assert losses[0] == losses[1] != losses[2]
    state.model.train()
    with pytest.raises(RuntimeError, match="Generator"), torch.no_grad():
        state.model.forward_batch(tb)


def test_remat_options_build_and_train(batch):
    """remat_layers and remat_deconv (models/backbone.maybe_remat) build and
    take a train step; tests/test_torch_variants.py holds their gradients."""
    for key in ("remat_layers", "remat_deconv"):
        state, step = build_training(_tcfg(**{key: True}), device="cpu")
        state, metrics = step(state, batch, 0)
        assert torch.isfinite(metrics["loss"]) and state.step == 1, key


# ---- checkpoints and loops -------------------------------------------------

def test_checkpoint_round_trip(batch, tmp_path):
    from pcf_torch.train.checkpoint import (CheckpointManager, load_params_only,
                                            save_params_only)

    tb = batch
    state, step = build_training(_tcfg(), device="cpu")
    state, _ = step(state, tb, 0)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for epoch, miou in ((1, 0.5), (2, 0.1), (3, 0.2)):
        mgr.save(epoch, state, {"miou": miou})
    assert (mgr.best_epoch(), mgr.latest_epoch()) == (1, 3)
    assert sorted(p.name for p in (tmp_path / "ck").glob("*.pt")) == ["1.pt", "3.pt"]

    fresh, _ = build_training(_tcfg(), device="cpu", seed=7)
    restored, epoch = CheckpointManager(str(tmp_path / "ck")).restore(fresh)
    assert epoch == 3 and restored.step == 1 and restored.tx.count == 1
    for (k, a), b in zip(state.model.state_dict().items(), restored.model.state_dict().values()):
        assert torch.equal(a, b), k
    params, stats, epoch = mgr.restore_eval(1)
    assert epoch == 1 and set(params) == {k for k, _ in state.model.named_parameters()}
    assert all(k.endswith(("running_mean", "running_var")) for k in stats)

    save_params_only(str(tmp_path / "p.pt"), params)
    loaded = load_params_only(str(tmp_path / "p.pt"), params)
    assert all(torch.equal(loaded[k], v) for k, v in params.items())
    with pytest.raises(KeyError):
        load_params_only(str(tmp_path / "p.pt"), {"nope": torch.zeros(1)})


def test_train_one_epoch_defers_and_flushes_metrics():
    """tests/test_train.py's loop contract for the port: metrics of every
    step reach the epoch's averages, the tail after the last print boundary
    included, and each step gets pcf_tpu's per-step seed."""
    from pcf_torch.parallel.mesh import step_seed
    from pcf_torch.train.trainer import train_one_epoch

    cfg = _tcfg(print_freq=2, num_classes=4)
    seeds = []

    def fake_step(state, batch, seed):
        seeds.append(seed)
        n = len(seeds)
        return state, {"loss": torch.tensor(float(n)), "intersection": torch.ones(4) * n,
                       "union": torch.ones(4) * n, "target": torch.ones(4) * n}

    state, loss, miou, macc, allacc = train_one_epoch(
        fake_step, None, [object()] * 5, None, 2, cfg, logging.getLogger("t"), 9)
    assert loss == pytest.approx(3.0) and miou == allacc == pytest.approx(1.0)
    assert seeds == [step_seed(9, 200000 + i) for i in range(5)]
    # under a mesh of one rank the loop runs the same steps (the ranks'
    # agreement on another batch is this rank's own)
    from pcf_torch.parallel.mesh import Mesh

    seeds.clear()
    mesh = Mesh(group=None, control=None, size=1, rank=0, device=torch.device("cpu"))
    _, loss, miou, _, _ = train_one_epoch(fake_step, None, [object()] * 3, mesh, 0, cfg,
                                          logging.getLogger("t"), 9)
    assert loss == pytest.approx(2.0) and miou == pytest.approx(1.0)
    assert seeds == [step_seed(9, i) for i in range(3)]


def test_validate_and_eval_step(batch):
    from pcf_torch.parallel import make_eval_step
    from pcf_torch.train.trainer import validate

    tb = batch
    cfg = _tcfg()
    model = build(cfg, device="cpu")
    state = TrainState(step=0, model=model, tx=None)
    logits = make_eval_step(cfg)(state, tb)
    inter, union, target = intersection_and_union(logits.argmax(-1), tb.labels, 5,
                                                  mask=tb.masks[0])
    miou, _, allacc = validate(make_eval_step(cfg), state, [tb, tb], None, cfg,
                               logging.getLogger("t"))
    assert miou == pytest.approx(float((inter / union.clamp_min(1)).mean()))
    assert allacc == pytest.approx(float(inter.sum() / target.sum()))
