"""The port's spatial sharding (parallel/spatial.py: one batch's points
sharded over the ranks; nn/sharded.py, the layers' all-gathered gather
sources; the loss summed over the shards; parallel/mesh.make_mesh_2d) on
four gloo ranks on the CPU, against the port's unsharded forward and step
and against pcf_tpu's spatial_eval_forward and make_spatial_train_step over
make_mesh(4) and a 2 x 2 mesh of the CPU's virtual devices
(tests/conftest.py), at tests/test_spatial.py's size (3 levels, base 16,
1,200 points, caps [2048, 1024, 512]) with its weights carried by
load_jax_variables. And trainer.main under spatial_train on two ranks.

The ranks are processes (tests/torch_dist_worker.py), started once for the
module, while this process computes the references, and killed at a
deadline. Where a gradient is compared every ReLU is smooth in both
packages (tests/test_torch_train_step.py: the train step's gradient has
kinks within f32 rounding). Tolerances: tests/test_spatial.py's against the
unsharded port (2e-5; 3e-5 for the 2 x 2 step), the model's and
test_torch_train_step.py's against pcf_tpu.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from pcf_tpu.config import Config as JConfig
from pcf_tpu.config import get_default_configs as j_defaults
from pcf_tpu.config import get_default_training_cfgs as j_train_defaults
from pcf_tpu.core import pack_scenes as j_pack
from pcf_tpu.data import synthetic_scene as j_scene
from pcf_tpu.data.pyramid import scene_to_item as j_item
from pcf_tpu.models import PointConvFormer_Segmentation as JSeg

import pcf_torch.data.pyramid as t_pyramid
from pcf_torch import config as t_config
from pcf_torch.config import Config, get_default_configs, get_default_training_cfgs
from pcf_torch.convert import load_jax_variables
from pcf_torch.core import pack_scenes
from pcf_torch.data import scene_to_item, synthetic_scene
from pcf_torch.entry import build
from pcf_torch.parallel.mesh import AXIS, Mesh, make_eager_train_step
from pcf_torch.parallel.spatial import make_spatial_eval_step
from pcf_torch.train.checkpoint import CheckpointManager
from pcf_torch.train.state import create_train_state, make_optimizer

from test_torch_mesh import _jsmooth
from test_torch_train_step import GRAD_ATOL, RTOL, _assert_grads_close
from test_torch_trainer import _cfg as _trainer_cfg
from test_torch_trainer import scene_dir  # noqa: F401 (the fixture)
from torch_dist_worker import start

GRID = [0.3, 0.6, 1.2]
CAPS = [2048, 1024, 512]
WORLD = 4
SEED = 3
# the unsharded port against the sharded one: tests/test_spatial.py's
SHARD_ATOL, SHARD_ATOL_2D = 2e-5, 3e-5
# the whole model against pcf_tpu's: tests/test_torch_model.py's
MODEL_ATOL, MODEL_RTOL = 5e-3, 1e-3
EVALS = {"pcf": {}, "stride_pe": {"guided_level": 99}, "selfmlp": {"use_level_1": False}}
# test_spatial.py's train step, but at a constant LR (under its warm-up the
# first step's LR is nearly 0 and the parameters barely move) and with no
# clip, so that an SGD step's move is linear in the gradient
TRAIN = dict(dropout_rate=0.0, drop_path_rate=0.0, dropout_fc=0.0, learning_rate=0.05,
             scheduler="Constant", optimizer="SGD", label_smoothing=0.2, BATCH_NORM=True,
             grad_clip_norm=1e9)


def _cfg(cls_config, defaults, train_defaults, **kw):
    """tests/test_spatial.py's _setup configuration."""
    cfg = train_defaults(defaults(cls_config(), num_level=3, base_dim=16))
    cfg.update(guided_level=0, num_heads=4, resblocks=[0, 2, 1], mid_dim=[4, 4, 4],
               grid_size=GRID, num_classes=10, resblocks_back=[1, 0, 0], mid_dim_back=4,
               USE_PE=True)
    cfg.update(kw)
    return cfg


def _jcfg(**kw):
    return _cfg(JConfig, j_defaults, j_train_defaults, **kw)


def _tcfg(**kw):
    return _cfg(Config, get_default_configs, get_default_training_cfgs, **kw)


def _args(b):
    return (b.feats, list(b.points), list(b.edges_self), list(b.edges_forward),
            list(b.edges_propagate), list(b.norms))


def _batches(pack, scene, item):
    """test_spatial.py's batch, and its 2-D test's second scene."""
    out = []
    for points, seed, rng in ((1200, 4, 0), (1100, 7, 7)):
        coord, norm, feats, labels = scene(points, extent=6.0, seed=seed, num_classes=10)
        out.append(pack([item(coord, norm, feats, labels, GRID, 8, 8, 8,
                              rng=np.random.default_rng(rng))], level_caps=CAPS))
    return out


def _port_step(cfg, variables, batch):
    model = load_jax_variables(build(cfg, device="cpu"), variables)
    state = create_train_state(model, make_optimizer(cfg, 10)[0])
    _, m = make_eager_train_step(cfg)(state, batch, SEED)
    return dict(metrics=m, grads={k: p.grad for k, p in model.named_parameters()},
                state=model.state_dict())


def _by_key(cfg, state):
    """pcf_tpu's TrainState as the port's state_dict."""
    model = build(cfg, device="cpu")
    load_jax_variables(model, {"params": jax.tree_util.tree_map(np.asarray, state.params),
                               "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                     state.batch_stats)})
    return model.state_dict()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, scene_dir):  # noqa: F811
    """The four ranks' results (torch_dist_worker.job_spatial), trainer.main
    on two ranks (job_spatial_main), and the references: the port's
    unsharded forwards and steps, pcf_tpu's spatial evals and steps."""
    mp = pytest.MonkeyPatch()
    mp.setattr(t_pyramid, "_USE_NATIVE", False)
    import pcf_tpu.data.pyramid as jp

    mp.setattr(jp, "_USE_NATIVE", False)
    tbs = _batches(pack_scenes, synthetic_scene, scene_to_item)
    jbs = _batches(j_pack, j_scene, j_item)
    variables = {}
    for name, over in EVALS.items():
        jmodel = JSeg(_jcfg(**over))
        variables[name] = jax.tree_util.tree_map(np.asarray, dict(jax.jit(
            lambda k, jmodel=jmodel: jmodel.init(k, *_args(jbs[0]), masks=list(jbs[0].masks),
                                                 train=False))(jax.random.PRNGKey(0))))
    kernel_cfg = _tcfg(USE_PALLAS_KERNEL=True, fused_min_points=0)
    dp_cfg = _tcfg(**TRAIN, bn_axis_name=AXIS, sync_bn=True)
    tmp = tmp_path_factory.mktemp("spatial")
    ranks = start("spatial", WORLD, dict(
        evals={k: (_tcfg(**o), variables[k]) for k, o in EVALS.items()},
        kernel_cfg=kernel_cfg, train_cfg=_tcfg(**TRAIN), dp_cfg=dp_cfg,
        variables=variables["pcf"], batch=tbs[0], batches2=tbs, seed=SEED), tmp,
        timeout=600)
    exp = tmp / "exp"
    main_cfg = _trainer_cfg(t_config, scene_dir, experiment_dir=str(exp), spatial_train=True,
                            total_epoches=2)
    mains = start("spatial_main", 2, dict(cfg=main_cfg), tmp, timeout=600)

    # pcf_tpu's spatial evals and steps over the virtual devices
    from pcf_tpu.parallel import make_mesh as j_make_mesh
    from pcf_tpu.parallel import make_spatial_train_step as j_spatial_train
    from pcf_tpu.parallel import spatial_eval_forward as j_spatial_eval
    from pcf_tpu.parallel.mesh import stack_batches
    from pcf_tpu.train.state import create_train_state as j_state
    from pcf_tpu.train.state import make_optimizer as j_optimizer

    mesh = j_make_mesh(WORLD)
    jeval = {name: np.asarray(j_spatial_eval(_jcfg(**EVALS[name]), v, jbs[0], mesh))
             for name, v in variables.items()}
    _jsmooth(mp)
    jcfg = _jcfg(**TRAIN)
    tx, _ = j_optimizer(jcfg, iter_per_epoch=10)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables["pcf"])
    s1, m1 = j_spatial_train(jcfg, tx, mesh)(j_state(jvars, tx), jbs[0],
                                            jax.random.PRNGKey(SEED))
    mesh2 = JMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "space"))
    s2, m2 = j_spatial_train(_jcfg(**TRAIN, sync_bn=True), tx, mesh2)(
        j_state(jvars, tx), stack_batches(jbs), jax.random.PRNGKey(SEED))

    # the port, unsharded: the forwards with the real ReLUs, the step smooth
    plain = {}
    with torch.no_grad():
        for name, over in EVALS.items():
            model = load_jax_variables(build(_tcfg(**over), device="cpu"), variables[name])
            plain[name] = model.eval().forward_batch(tbs[0])
        kernel_plain = build(kernel_cfg, device="cpu", seed=0).eval().forward_batch(tbs[0])
    from torch.nn import functional as F

    softplus = F.softplus
    mp.setattr(F, "relu", lambda x, inplace=False: softplus(x))
    mp.setattr(F, "leaky_relu", lambda x, negative_slope=0.01, inplace=False: (
        negative_slope * x + (1 - negative_slope) * softplus(x)))
    port_step = _port_step(_tcfg(**TRAIN), variables["pcf"], tbs[0])
    mp.undo()
    return dict(
        ranks=ranks(), mains=mains(), exp=exp, tbs=tbs, jeval=jeval, plain=plain,
        kernel_plain=kernel_plain, port_step=port_step,
        j1=dict(metrics={k: np.asarray(v) for k, v in m1.items()},
                state=_by_key(_tcfg(**TRAIN), s1)),
        j2=dict(metrics={k: np.asarray(v) for k, v in m2.items()},
                state=_by_key(_tcfg(**TRAIN), s2)),
        init=load_jax_variables(build(_tcfg(), device="cpu"), variables["pcf"]).state_dict())


@pytest.mark.parametrize("name", list(EVALS))
def test_spatial_eval_matches_unsharded_and_pcf_tpu(runs, name):
    """The full logits on every rank: within 2e-5 of the port's unsharded
    forward on the valid rows, and within the model tolerance of pcf_tpu's
    spatial_eval_forward over four devices."""
    m = runs["tbs"][0].masks[0]
    want = runs["plain"][name]
    for out in runs["ranks"]:
        got = out["eval"][name]
        assert got.shape == want.shape
        np.testing.assert_allclose(got[m].numpy(), want[m].numpy(), atol=SHARD_ATOL)
        np.testing.assert_allclose(got[m].numpy(), runs["jeval"][name][m.numpy()],
                                   atol=MODEL_ATOL, rtol=MODEL_RTOL)


def test_spatial_eval_on_the_kernel_route(runs):
    """USE_PALLAS_KERNEL with fused_min_points=0: kernels B and C (their
    plain versions here) on each shard's rows against tables of every row,
    within 2e-5 of the unsharded forward on the same route."""
    m = runs["tbs"][0].masks[0]
    for out in runs["ranks"]:
        np.testing.assert_allclose(out["kernel_eval"][m].numpy(),
                                   runs["kernel_plain"][m].numpy(), atol=SHARD_ATOL)


def test_indivisible_caps_raise_before_any_collective():
    """A level cap that eight ranks do not divide raises "not divisible"
    before the step reaches a collective: here no process group exists, so
    any collective would fail otherwise."""
    tb = _batches(pack_scenes, synthetic_scene, scene_to_item)[0]
    bad = replace(tb, points=(tb.points[0][:1500],) + tb.points[1:])
    mesh = Mesh(None, None, 8, 0, torch.device("cpu"), (8,))
    model = build(_tcfg(), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        make_spatial_eval_step(_tcfg(), mesh)(model, bad)


def _crossing_edges(batch, n):
    """Edges whose row is in one shard of `n` and whose neighbour in another."""
    count = 0
    for edges in (batch.edges_self, batch.edges_forward):
        for e, src in zip(edges, batch.points):
            shard = e.shape[0] // n
            home = torch.arange(e.shape[0])[:, None] // shard
            count += int((e.long() // (src.shape[0] // n) != home).sum())
    return count


def test_spatial_train_step_matches_unsharded_and_pcf_tpu(runs):
    """One SGD step over four ranks: the loss within 1e-5 of the unsharded
    step's, the IoU histograms equal, every gradient within
    test_torch_train_step.py's tolerance, every parameter and BN statistic
    within 2e-5, on every rank; against pcf_tpu's make_spatial_train_step
    the loss within 1e-5, the histograms as tests/test_torch_mesh.py holds
    them, and the step's moves within test_torch_train_step.py's tolerance.
    The batch has edges that cross shard boundaries, whose gradients only
    the all-gather's reduce-scatter backward brings home, and the loss is
    summed once over the shards."""
    assert _crossing_edges(runs["tbs"][0], WORLD) > 1000
    want, j1, init = runs["port_step"], runs["j1"], runs["init"]
    loss = float(want["metrics"]["loss"])
    for out in runs["ranks"]:
        got = out["train"]
        assert abs(float(got["metrics"]["loss"]) - loss) <= 1e-5 * abs(loss)
        _against_port(got, want, SHARD_ATOL)
        _against_pcf_tpu(got, j1, init, WORLD)


def _against_port(got, want, atol):
    for k in ("intersection", "union", "target"):
        torch.testing.assert_close(got["metrics"][k], want["metrics"][k], atol=0, rtol=0)
    _assert_grads_close({k: g.numpy() for k, g in got["grads"].items()},
                        {k: g.numpy() for k, g in want["grads"].items()})
    for k, v in got["state"].items():
        np.testing.assert_allclose(v.numpy(), want["state"][k].numpy(), atol=atol, err_msg=k)


def _against_pcf_tpu(got, j, init, space):
    """The port's step against pcf_tpu's spatial step: the loss, histograms
    and BN statistics; the parameters' moves against pcf_tpu's divided by
    the space axis's size. pcf_tpu's gradient is `space` times the
    unsharded step's (a fault of pcf_tpu that the port does not copy,
    ROADMAP.md Queue 3): its loss psums the numerator inside
    jax.value_and_grad, whose transpose under shard_map(check_vma=False)
    psums the cotangent, so each shard's gradient is already the whole
    scene's before the step psums the gradients over the shards."""
    loss = float(j["metrics"]["loss"])
    assert abs(float(got["metrics"]["loss"]) - loss) <= 1e-5 * abs(loss)
    np.testing.assert_array_equal(got["metrics"]["target"].numpy(), j["metrics"]["target"])
    for k in ("intersection", "union"):
        np.testing.assert_allclose(got["metrics"][k].numpy(), j["metrics"][k], atol=1.0)
    params = [k for k in got["state"] if not k.endswith(("running_mean", "running_var"))]
    _assert_grads_close({k: (got["state"][k] - init[k]).numpy() for k in params},
                        {k: (j["state"][k] - init[k]).numpy() / space for k in params})
    for k in got["state"]:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["state"][k].numpy(), j["state"][k].numpy(),
                                       atol=GRAD_ATOL, rtol=RTOL, err_msg=k)


def test_2d_step_matches_data_parallel_and_pcf_tpu(runs):
    """The (2, 2) mesh's step, each data index on its own batch: within 3e-5
    of the port's 2-rank data-parallel step with SyncBN on the same two
    batches (the loss averaged, histograms summed, parameters and BN
    statistics), on every rank; and against pcf_tpu's step over the 2 x 2
    mesh of virtual devices as the 1-D step is."""
    for out in runs["ranks"]:
        got, want = out["train2d"], out["dp"]
        loss = float(want["metrics"]["loss"])
        assert abs(float(got["metrics"]["loss"]) - loss) <= 1e-5 * abs(loss)
        _against_port(got, want, SHARD_ATOL_2D)
        _against_pcf_tpu(got, runs["j2"], runs["init"], WORLD // 2)


def test_trainer_main_under_spatial_train(runs):
    """trainer.main with spatial_train on two gloo ranks, two epochs of one
    step: both ranks handed every step the same batch, the whole loader's,
    log the same losses and end in the same state; rank 0 alone logs and
    checkpoints, and its checkpoint is that state."""
    a, b = runs["mains"]
    assert a["steps"] == b["steps"] == 2 and len(a["batches"]) == 2
    for x, y in zip(a["batches"], b["batches"]):
        assert len(x) == len(y) and all(torch.equal(s, t) for s, t in zip(x, y))
    assert a["losses"] == b["losses"] and all(np.isfinite(a["losses"]))
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k
    exp = runs["exp"]
    assert sorted(p.name for p in exp.iterdir()) == ["code_log", "log.txt", "metrics.jsonl",
                                                      "model"]
    log = (exp / "log.txt").read_text()
    assert "rank 0 of 2" in log and "rank 1 of 2" not in log
    params, stats, epoch = CheckpointManager(str(exp / "model")).restore_eval()
    assert epoch == 2
    for k, v in a["state"].items():
        assert torch.equal(v, {**params, **stats}[k]), k
