"""pcf_torch's whole train step against pcf_tpu's on a small windowed model
with the weights carried by load_jax_variables: pcf_tpu's
parallel.make_train_step(mesh=None) with its Pallas kernels in interpret
mode, the port's make_train_step with its kernels' plain versions. The
step-0 loss and every parameter gradient, then three SGD steps (losses, BN
running statistics) and three AdamW steps (losses).

At these weights (PRNGKey(0)) the train step's gradient has kinks within
f32 rounding: ReLU inputs next to zero after train-mode BatchNorm, which the
two packages' f32 forwards put on different sides, so their raw train-step
gradients differ beyond a per-parameter tolerance although each is a
gradient of the same loss. So the train step is held with every ReLU
replaced by the same smooth function in both packages, where the gradients
agree per parameter, and with the real ReLUs under BatchNorm on its running
statistics; and the port's own f32 train-step gradients are held to its
float64 ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcf_tpu.core import pack_scenes as j_pack
from pcf_tpu.data import synthetic_scene as j_scene
from pcf_tpu.data.pyramid import scene_to_item as j_item
from pcf_tpu.models import PointConvFormer_Segmentation as JSeg
from pcf_tpu.train.loss import cross_entropy_loss as j_ce

from pcf_torch.convert import load_jax_variables
from pcf_torch.core import pack_scenes
from pcf_torch.data import scene_to_item, synthetic_scene
from pcf_torch.entry import build, build_training
from pcf_torch.train.loss import cross_entropy_loss
from pcf_torch.train.state import create_train_state, make_optimizer
import pcf_torch.data.pyramid as t_pyramid

from test_torch_train import GRID, _jcfg, _tcfg

# gradients and BN statistics: tests/test_pallas_model.py's tolerance between
# pcf_tpu's own paths, the gradient's atol scaled by its largest entry
GRAD_ATOL, RTOL = 5e-3, 1e-3


def _args(b):
    return (b.feats, list(b.points), list(b.edges_self), list(b.edges_forward),
            list(b.edges_propagate), list(b.norms))


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def pair(monkeypatch_module):
    """The windowed batch of tests/test_torch_model.py in both packages, and
    pcf_tpu's initial variables (numpy leaves)."""
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
    jmodel = JSeg(_jcfg())
    variables = jax.jit(lambda k: jmodel.init(k, *_args(jb), masks=list(jb.masks),
                                              train=False))(jax.random.PRNGKey(0))
    return jb, tb, jax.tree_util.tree_map(np.asarray, dict(variables))


@pytest.fixture
def smooth_relus(monkeypatch):
    """Every ReLU and leaky ReLU of both packages replaced by one smooth
    function, softplus (slope*x + (1 - slope)*softplus(x) for the leaky one):
    the train step's gradient then has no kink for rounding to cross."""
    import flax.linen as fnn
    from torch.nn import functional as F

    softplus = F.softplus
    monkeypatch.setattr(fnn, "relu", jax.nn.softplus)
    monkeypatch.setattr(fnn, "leaky_relu", lambda x, negative_slope=0.01: (
        negative_slope * x + (1 - negative_slope) * jax.nn.softplus(x)))
    monkeypatch.setattr(F, "relu", lambda x, inplace=False: softplus(x))
    monkeypatch.setattr(F, "leaky_relu", lambda x, negative_slope=0.01, inplace=False: (
        negative_slope * x + (1 - negative_slope) * softplus(x)))


def _port_state(cfg, variables, iter_per_epoch=5):
    model = load_jax_variables(build(cfg, device="cpu"), variables)
    tx, _ = make_optimizer(cfg, iter_per_epoch)
    return create_train_state(model, tx)


def _assert_grads_close(got: dict, want: dict):
    """Each parameter's gradient within GRAD_ATOL of its largest entry. A
    gradient that is zero but for rounding (a bias that a BatchNorm cancels)
    takes 1% of the tree's largest entry as its scale instead."""
    tree_max = max(np.abs(np.asarray(w)).max() for w in want.values())
    for key, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[key], w, rtol=RTOL,
                                   atol=GRAD_ATOL * max(np.abs(w).max(), 1e-2 * tree_max),
                                   err_msg=key)


def _port_loss(logits, batch):
    return cross_entropy_loss(logits, batch.labels, mask=batch.masks[0])


def _jax_grads_by_torch_key(model, grads, batch_stats):
    """pcf_tpu's gradient tree keyed like the port's parameters (the same
    map load_jax_variables applies to weights)."""
    load_jax_variables(model, {"params": jax.tree_util.tree_map(np.asarray, grads),
                               "batch_stats": batch_stats})
    return {k: p.detach().numpy().copy() for k, p in model.named_parameters()}


def _jax_loss_and_grads(pair, train: bool):
    """pcf_tpu's loss and jax.value_and_grad of it, as its make_train_step
    takes them (train=True) or with BatchNorm on its running statistics."""
    from pcf_tpu.parallel.mesh import _forward

    jb, _, variables = pair
    jmodel, cfg = JSeg(_jcfg()), _jcfg()

    def loss_fn(params):
        logits, _ = _forward(jmodel, params, variables["batch_stats"], jb, cfg, train,
                             jax.random.PRNGKey(0))
        return j_ce(logits, jb.labels, mask=jb.masks[0])[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    return float(loss), _jax_grads_by_torch_key(build(_tcfg(), device="cpu"), grads,
                                                variables["batch_stats"])


def test_train_step_gradients_match_pcf_tpu(pair, smooth_relus):
    """Step 0, every ReLU smooth in both packages: the loss within 1e-5
    relative and every parameter gradient within 5e-3 of its largest entry
    (rtol 1e-3), pcf_tpu's jax.value_and_grad of its make_train_step loss
    against the raw .grad the port's step leaves."""
    _, tb, variables = pair
    want_loss, want_grads = _jax_loss_and_grads(pair, train=True)
    state, step = build_training(_tcfg(), device="cpu")
    load_jax_variables(state.model, variables)
    state, metrics = step(state, tb, 0)
    assert abs(float(metrics["loss"]) - want_loss) <= 1e-5 * abs(want_loss)
    _assert_grads_close({k: p.grad.numpy() for k, p in state.model.named_parameters()},
                        want_grads)
    assert state.step == 1
    assert set(metrics) == {"loss", "intersection", "union", "target"}


def test_frozen_bn_gradients_match_pcf_tpu(pair):
    """The real ReLUs, BatchNorm on its running statistics: every parameter
    gradient within 5e-3 of its largest entry (rtol 1e-3). And in the train
    step the port's f32 gradients are its float64 gradients (the same
    tolerance): its rounding alone moves none of them."""
    _, tb, variables = pair
    _, want_grads = _jax_loss_and_grads(pair, train=False)
    model = load_jax_variables(build(_tcfg(), device="cpu"), variables)
    loss, _ = _port_loss(model.forward_batch(tb), tb)
    loss.backward()
    _assert_grads_close({k: p.grad.numpy() for k, p in model.named_parameters()},
                        want_grads)

    grads = {}
    for dtype in (torch.float32, torch.float64):
        state, step = build_training(_tcfg(), device="cpu")
        load_jax_variables(state.model, variables).to(dtype)
        step(state, tb.to("cpu", dtype), 0)
        grads[dtype] = {k: p.grad.double().numpy() for k, p in state.model.named_parameters()}
    _assert_grads_close(grads[torch.float32], grads[torch.float64])


@pytest.mark.parametrize("opt_name,loss_rtol", [("SGD", 1e-4), ("AdamW", 1e-3)])
def test_train_steps_match_pcf_tpu(pair, opt_name, loss_rtol):
    """Three steps of pcf_tpu.parallel.make_train_step(mesh=None) and of the
    port's: the losses, and after SGD the BN running statistics."""
    from pcf_tpu.parallel import make_train_step as j_make_train_step
    from pcf_tpu.train.state import create_train_state as j_state
    from pcf_tpu.train.state import make_optimizer as j_make_optimizer

    jb, tb, variables = pair
    jcfg = _jcfg(optimizer=opt_name)
    tx, _ = j_make_optimizer(jcfg, iter_per_epoch=5)
    jstate = j_state(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    jstep = j_make_train_step(JSeg(jcfg), tx, jcfg)
    state = _port_state(_tcfg(optimizer=opt_name), variables)
    from pcf_torch.parallel import make_train_step

    step = make_train_step(_tcfg(optimizer=opt_name))
    for i in range(3):
        jstate, jm = jstep(jstate, jb, jax.random.PRNGKey(i))
        state, m = step(state, tb, i)
        want = float(jm["loss"])
        assert abs(float(m["loss"]) - want) <= loss_rtol * abs(want), (i, float(m["loss"]), want)
        np.testing.assert_array_equal(m["target"].numpy(), np.asarray(jm["target"]))
    if opt_name == "SGD":
        ref = build(_tcfg(), device="cpu")
        load_jax_variables(ref, {"params": jax.tree_util.tree_map(np.asarray, jstate.params),
                                 "batch_stats": jax.tree_util.tree_map(
                                     np.asarray, jstate.batch_stats)})
        want_state = ref.state_dict()
        for key, v in state.model.state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), want_state[key].numpy(),
                                           atol=GRAD_ATOL, rtol=RTOL, err_msg=key)
