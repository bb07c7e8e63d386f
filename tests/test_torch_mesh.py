"""The port's data-parallel steps (parallel/mesh.py: make_mesh, the train
step's gradient pmean and metric reductions, the rank-folded seed) and
SyncBN (nn/norm.synced_batch_stats) on two gloo ranks on the CPU, against
pcf_tpu's make_train_step and make_eval_step over make_mesh(2) on the CPU's
virtual devices (tests/conftest.py), fed stack_batches of the same two
batches, with the weights carried by load_jax_variables.

The ranks are processes (tests/torch_dist_worker.py), started once for the
module, while this process computes pcf_tpu's steps, and killed at a
deadline: a hung rendezvous fails the tests. Both
packages run their plain paths (no Pallas, XLA gathers: the collectives are
what is held here) and every ReLU smooth (tests/test_torch_train_step.py:
the train step's gradient has kinks within f32 rounding). Tolerances are
test_torch_train_step.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pcf_tpu.core import pack_scenes as j_pack
from pcf_tpu.data import synthetic_scene as j_scene
from pcf_tpu.data.pyramid import scene_to_item as j_item
from pcf_tpu.models import PointConvFormer_Segmentation as JSeg
from pcf_tpu.parallel.mesh import AXIS, make_mesh as j_make_mesh, stack_batches
from pcf_tpu.train.loss import cross_entropy_loss as j_ce

import pcf_torch.data.pyramid as t_pyramid
from pcf_torch.convert import load_jax_variables
from pcf_torch.core import pack_scenes
from pcf_torch.data import scene_to_item, synthetic_scene
from pcf_torch.entry import build
from pcf_torch.nn.norm import MaskedBatchNorm
from pcf_torch.parallel.mesh import make_eager_train_step, step_seed
from pcf_torch.train.state import create_train_state, make_optimizer

from test_torch_train import GRID, _jcfg, _tcfg
from test_torch_train_step import GRAD_ATOL, RTOL, _assert_grads_close
from torch_dist_worker import start

SEED = 7
PLAIN = dict(USE_PALLAS_KERNEL=False, resolve_impl="xla", window_gather=True,
             optimizer="SGD", scheduler="Constant", learning_rate=0.05)


def _args(b):
    return (b.feats, list(b.points), list(b.edges_self), list(b.edges_forward),
            list(b.edges_propagate), list(b.norms))


def _packed(pack, scene, item, seeds, caps=None):
    kw = dict(window_tile=16, window_size=128)
    out = []
    for s in seeds:
        c, n, f, l = scene(250 + 30 * s, extent=4.0, num_classes=5, seed=s)
        out.append(pack([item(c, n, f, l, GRID, 8, 8, 8, rng=np.random.default_rng(s),
                              morton=True)], level_caps=caps, bucket_multiple=128, **kw))
    return out


def _jsmooth(mp):
    import flax.linen as fnn

    mp.setattr(fnn, "relu", jax.nn.softplus)
    mp.setattr(fnn, "leaky_relu", lambda x, negative_slope=0.01: (
        negative_slope * x + (1 - negative_slope) * jax.nn.softplus(x)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' two-rank steps on the same batches and weights: pcf_tpu's
    results (eval logits, the pmean'd loss and gradients, the state and
    metrics after its make_train_step), the port's per rank, and what the
    single-process comparisons need."""
    mp = pytest.MonkeyPatch()
    mp.setattr(t_pyramid, "_USE_NATIVE", False)
    import pcf_tpu.data.pyramid as jp

    mp.setattr(jp, "_USE_NATIVE", False)
    seeds = (3, 4)
    first = _packed(pack_scenes, synthetic_scene, scene_to_item, seeds)
    caps = [max(int(b.points[i].shape[0]) for b in first) for i in range(len(GRID))]
    tbs = _packed(pack_scenes, synthetic_scene, scene_to_item, seeds, caps)
    jbs = _packed(j_pack, j_scene, j_item, seeds, caps)
    jcfg = _jcfg(**PLAIN, bn_axis_name=AXIS, sync_bn=True)
    tcfg = _tcfg(**PLAIN, bn_axis_name=AXIS, sync_bn=True)
    jmodel = JSeg(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(lambda k: jmodel.init(
        k, *_args(jbs[0]), masks=list(jbs[0].masks), train=False))(jax.random.PRNGKey(0))))

    rng = np.random.default_rng(11)
    bn_rows = (torch.from_numpy(rng.standard_normal((2 * 300, 6)).astype(np.float32) * 3 + 1),
               torch.from_numpy(rng.random(2 * 300) < 0.8),
               torch.from_numpy(rng.standard_normal((2 * 300, 6)).astype(np.float32)))
    drop_cfg = _tcfg(**PLAIN, drop_path_rate=0.3)
    ranks = start("steps", 2, dict(cfg=tcfg, drop_cfg=drop_cfg, variables=variables,
                                   batches=tbs, seed=SEED, smooth=True, bn=bn_rows),
                  tmp_path_factory.mktemp("mesh"))

    _jsmooth(mp)
    from pcf_tpu.parallel import make_eval_step as j_eval_step
    from pcf_tpu.parallel import make_train_step as j_train_step
    from pcf_tpu.parallel.mesh import _forward, _squeeze0
    from pcf_tpu.train.state import create_train_state as j_state
    from pcf_tpu.train.state import make_optimizer as j_optimizer

    mesh = j_make_mesh(2)
    stacked = stack_batches(jbs)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    logits = j_eval_step(jmodel, jcfg, mesh)(j_state(jvars, j_optimizer(jcfg, 5)[0]), stacked)

    def loss_and_grads(params, batch):  # pcf_tpu's device_step, up to its pmean
        b = _squeeze0(batch)

        def loss_fn(p):
            out, _ = _forward(jmodel, p, jvars["batch_stats"], b, jcfg, True,
                              jax.random.PRNGKey(SEED))
            return j_ce(out, b.labels, mask=b.masks[0])[0]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        return jax.lax.pmean(loss, AXIS), jax.lax.pmean(grads, AXIS)

    loss, grads = jax.jit(jax.shard_map(loss_and_grads, mesh=mesh, in_specs=(P(), P(AXIS)),
                                        out_specs=(P(), P()), check_vma=False))(
        jvars["params"], stacked)
    tx, _ = j_optimizer(jcfg, 5)
    jstate, jm = j_train_step(jmodel, tx, jcfg, mesh)(j_state(jvars, tx), stacked,
                                                      jax.random.PRNGKey(SEED))
    mp.undo()

    def by_key(params, stats):
        model = build(tcfg, device="cpu")
        load_jax_variables(model, {"params": jax.tree_util.tree_map(np.asarray, params),
                                   "batch_stats": jax.tree_util.tree_map(np.asarray, stats)})
        return model

    grad_model = by_key(grads, variables["batch_stats"])
    return dict(
        port=ranks(), tbs=tbs, variables=variables, drop_cfg=drop_cfg, bn=bn_rows,
        logits=np.asarray(logits), loss=float(loss),
        grads={k: p.detach().numpy() for k, p in grad_model.named_parameters()},
        state=by_key(jstate.params, jstate.batch_stats).state_dict(),
        init=by_key(variables["params"], variables["batch_stats"]).state_dict(),
        metrics={k: np.asarray(v) for k, v in jm.items()})


def test_eval_step_gives_each_rank_its_own_logits(runs):
    """pcf_tpu's eval step over the mesh returns [2, ...] logits, device d's
    from batch d; each port rank's from its own batch, within the model
    tolerance of tests/test_torch_model.py."""
    for r, out in enumerate(runs["port"]):
        np.testing.assert_allclose(out["logits"].numpy(), runs["logits"][r], atol=1e-4,
                                   rtol=1e-4)


def test_train_step_over_two_ranks_matches_pcf_tpu(runs):
    """The loss averaged over the ranks, every gradient pmean'd (with SyncBN:
    the statistics of both batches), the parameters after the SGD step and
    the BN running statistics, on both ranks alike and as pcf_tpu's."""
    for out in runs["port"]:
        assert abs(float(out["metrics"]["loss"]) - runs["loss"]) <= 1e-5 * abs(runs["loss"])
        assert abs(float(out["metrics"]["loss"]) - float(runs["metrics"]["loss"])) <= \
            1e-5 * abs(runs["loss"])
        _assert_grads_close({k: g.numpy() for k, g in out["grads"].items()}, runs["grads"])
        moved = {k: (out["state"][k] - runs["init"][k]).numpy() for k in out["grads"]}
        want = {k: (runs["state"][k] - runs["init"][k]).numpy() for k in out["grads"]}
        _assert_grads_close(moved, want)
        for key, v in out["state"].items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), runs["state"][key].numpy(),
                                           atol=GRAD_ATOL, rtol=RTOL, err_msg=key)
    a, b = runs["port"]
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k


def test_train_step_metrics_are_reduced_over_the_ranks(runs):
    """The IoU histograms summed over both batches, as pcf_tpu's psum: the
    target counts exactly, the predictions' within one point."""
    for out in runs["port"]:
        m = out["metrics"]
        np.testing.assert_array_equal(m["target"].numpy(), runs["metrics"]["target"])
        for k in ("intersection", "union"):
            np.testing.assert_allclose(m[k].numpy(), runs["metrics"][k], atol=1.0, err_msg=k)
    t = sum(float(b.masks[0].sum()) for b in runs["tbs"])
    assert float(runs["port"][0]["metrics"]["target"].sum()) <= t


def test_drop_path_seed_is_folded_with_the_rank(runs, monkeypatch):
    """With DropPath on (and no SyncBN), rank r draws from step_seed(seed, r):
    the averaged gradients are the mean of two single-process steps, batch
    r seeded step_seed(seed, r) (every ReLU smooth, as on the ranks)."""
    from torch.nn import functional as F

    softplus = F.softplus
    monkeypatch.setattr(F, "relu", lambda x, inplace=False: softplus(x))
    monkeypatch.setattr(F, "leaky_relu", lambda x, negative_slope=0.01, inplace=False: (
        negative_slope * x + (1 - negative_slope) * softplus(x)))
    want = {}
    for r, batch in enumerate(runs["tbs"]):
        model = load_jax_variables(build(runs["drop_cfg"], device="cpu"), runs["variables"])
        state = create_train_state(model, make_optimizer(runs["drop_cfg"], 5)[0])
        make_eager_train_step(runs["drop_cfg"])(state, batch, step_seed(SEED, r))
        for k, p in model.named_parameters():
            want[k] = want.get(k, 0) + p.grad / 2
    for out in runs["port"]:
        for k, g in out["drop_grads"].items():
            torch.testing.assert_close(g, want[k], atol=1e-6, rtol=1e-5, msg=k)


def test_sync_bn_equals_one_forward_on_both_ranks_rows(runs):
    """SyncBN: each rank's output, input gradient and running statistics are
    those of one MaskedBatchNorm forward over both ranks' rows together (as
    tests/test_sharding.py holds pcf_tpu's psum'd BN); the parameter
    gradients, summed over the ranks, are its (JAX's psum transposed)."""
    x, mask, w = runs["bn"]
    x = x.clone().requires_grad_(True)
    bn = MaskedBatchNorm(x.shape[-1])
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
    y = bn(x, mask)
    (y * w).sum().backward()
    ys, xg = y.detach().chunk(2), x.grad.chunk(2)
    outs = [o["bn"] for o in runs["port"]]
    for r, o in enumerate(outs):
        torch.testing.assert_close(o["y"], ys[r], atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(o["x_grad"], xg[r], atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(o["mean"], bn.running_mean, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(o["var"], bn.running_var, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(outs[0]["weight_grad"] + outs[1]["weight_grad"], bn.weight.grad,
                               atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(outs[0]["bias_grad"] + outs[1]["bias_grad"], bn.bias.grad,
                               atol=1e-4, rtol=1e-5)
