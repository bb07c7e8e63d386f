"""pcf_torch's trainer `main` and simple evaluation on the CPU, with a tiny
model: training, checkpoints, resume and its warm start, the profiler trace,
the unported modes that must raise, the eval writers' bytes against
pcf_tpu's, and evaluate's outputs against pcf_tpu's on the same scenes and
weights (f32, the plain conv path): probabilities within 1e-4, labels and
mIoU equal wherever the top-2 margin is above 1e-4."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import pcf_tpu.data.pyramid as j_pyramid
from pcf_tpu import config as j_config
from pcf_tpu.core.batching import pack_scenes as j_pack
from pcf_tpu.data.scannet import ScanNetDataset as JDataset
from pcf_tpu.eval import io as j_io
from pcf_tpu.eval.simple import evaluate as j_evaluate
from pcf_tpu.models import PointConvFormer_Segmentation as JModel
from pcf_tpu.train.state import create_train_state as j_state
from pcf_tpu.train.state import make_optimizer as j_optimizer

import chip_smoke
import pcf_torch.data.pyramid as t_pyramid
from pcf_torch import config as t_config
from pcf_torch.convert import load_jax_variables
from pcf_torch.data.synthetic import synthetic_scene
from pcf_torch.entry import build
from pcf_torch.eval import io as t_io
from pcf_torch.eval.simple import evaluate as t_evaluate
from pcf_torch.train import trainer
from pcf_torch.train.checkpoint import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NCLS = 5
MARGIN = 1e-4


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    for split, base in (("train", 0), ("val", 50)):
        os.makedirs(d / split)
        for i in range(3):
            coord, norm, feats, labels = synthetic_scene(400, extent=4.0, num_classes=NCLS,
                                                         seed=base + i)
            np.savez(d / split / f"scene{i}.npz", coords=coord,
                     feats=np.concatenate([feats, norm], 1), labels=labels,
                     name=f"{split}_scene{i}")
    return d


def _cfg(mod, scene_dir, **kw):
    cfg = mod.get_default_training_cfgs(mod.get_default_configs(mod.Config(), num_level=3,
                                                                base_dim=8))
    cfg.update(guided_level=0, num_heads=2, resblocks=[0, 1, 1], mid_dim=[4, 4, 4],
               grid_size=[0.35, 0.7, 1.4], num_classes=NCLS, learning_rate=0.01,
               scheduler="MultiStepWithWarmup", milestones=[1000], warmup_epochs=1,
               BATCH_SIZE=2, bucket_multiple=256, MAX_POINTS_NUM=100000,
               train_data_path=str(scene_dir / "train" / "*.npz"),
               val_data_path=str(scene_dir / "val" / "*.npz"),
               test_data_path=str(scene_dir / "val" / "*.npz"),
               K_self=[8] * 3, K_forward=[8] * 3, K_propagate=[8] * 3, total_epoches=1,
               eval_freq=1, save_freq=1, print_freq=2, window_gather=True,
               window_sizes=(384, 384, 256), pin_level_caps=True, level_caps_sample=3)
    cfg.update(kw)
    return cfg


# ---- main ------------------------------------------------------------------

def test_main_trains_checkpoints_and_resumes(scene_dir, tmp_path):
    exp = tmp_path / "exp"
    cfg = _cfg(t_config, scene_dir, experiment_dir=str(exp))
    state = trainer.main(cfg.copy(), device="cpu")
    assert state.step == state.tx.count == 1  # 3 scenes, batch 2, drop_last
    lines = [json.loads(x) for x in (exp / "metrics.jsonl").read_text().splitlines()]
    assert [("train_loss" in r, "val_miou" in r) for r in lines] == [(True, False),
                                                                      (False, True)]
    assert np.isfinite(lines[0]["train_loss"])
    assert sorted(p.name for p in (exp / "model").iterdir()) == ["1.pt", "metrics.json"]
    assert (exp / "code_log" / "pcf_torch" / "train" / "trainer.py").exists()
    assert not (exp / "code_log" / "pcf_torch" / "_build").exists()

    cfg2 = cfg.copy()
    cfg2.total_epoches = 2
    state = trainer.main(cfg2, device="cpu")
    log = (exp / "log.txt").read_text()
    assert "resumed from epoch 1" in log and "warm-started" not in log
    assert state.step == state.tx.count == 2
    assert len((exp / "metrics.jsonl").read_text().splitlines()) == 4
    params, stats, epoch = CheckpointManager(str(exp / "model")).restore_eval()
    assert epoch == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, {**params, **stats}[k]), k


def test_main_warm_starts_from_another_optimizers_checkpoint(scene_dir, tmp_path):
    """A checkpoint whose optimizer state does not fit (SGD, then AdamW):
    the weights and BN statistics are restored, the optimizer starts fresh."""
    exp = tmp_path / "exp"
    trainer.main(_cfg(t_config, scene_dir, experiment_dir=str(exp), optimizer="SGD"),
                 device="cpu")
    params, stats, _ = CheckpointManager(str(exp / "model")).restore_eval()
    # total_epoches 1: nothing left to train, main returns the warm-started state
    state = trainer.main(_cfg(t_config, scene_dir, experiment_dir=str(exp)), device="cpu")
    log = (exp / "log.txt").read_text()
    assert "full-state restore failed (ValueError" in log and "resumed from epoch 1" in log
    assert state.step == state.tx.count == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, {**params, **stats}[k]), k


def test_profile_dir_traces_only_profile_epoch(scene_dir, tmp_path):
    cfg = _cfg(t_config, scene_dir, experiment_dir=str(tmp_path / "exp"), BATCH_SIZE=1,
               total_epoches=2, eval_freq=5, save_freq=5, profile_dir=str(tmp_path / "prof"),
               profile_epoch=1, profile_steps=1)
    trainer.main(cfg, device="cpu")
    assert sorted(os.listdir(tmp_path / "prof")) == ["train_epoch1.spans.json",
                                                     "train_epoch1.trace.json"]
    trace = json.loads((tmp_path / "prof" / "train_epoch1.trace.json").read_text())
    assert trace["traceEvents"]
    spans = json.loads((tmp_path / "prof" / "train_epoch1.spans.json").read_text())
    assert [s["name"] for s in spans if s["parent"] is None] == ["step.train"]


@pytest.mark.parametrize("key,value", [("spatial_train", True)])
def test_unported_modes_raise(scene_dir, tmp_path, key, value):
    """Spatial sharding is implemented for the PCF layer family only, in
    pcf_tpu too: spatial_train with the PointTransformer layers raises
    before main joins a group or writes anything."""
    cfg = _cfg(t_config, scene_dir, experiment_dir=str(tmp_path / "exp"),
               transformer_type="PointTransformer", **{key: value})
    with pytest.raises(NotImplementedError, match="PCF layer family"):
        trainer.main(cfg, device="cpu")
    assert not (tmp_path / "exp").exists()


def _rank_outputs(exp):
    return sorted(p.name for p in exp.iterdir())


@pytest.mark.parametrize("key,value", [("data_parallel", 2), ("multi_host", True)])
def test_parallel_modes_run(scene_dir, tmp_path, monkeypatch, key, value):
    """data_parallel 2: main on two gloo ranks (tests/torch_dist_worker.py),
    each on its shard of the scenes (BATCH_SIZE 1: 2 and 1 train scenes, so
    the ranks stop together after one step), SyncBN over a mesh; both end
    with the same parameters and BN statistics, only rank 0 logs, writes
    metrics and checkpoints, and a second run resumes from its checkpoint.
    multi_host: one rank of a torchrun-style group of one, in this process
    (the bootstrap, no mesh), which trains and checkpoints as main does."""
    from torch_dist_worker import free_port, spawn

    exp = tmp_path / "exp"
    cfg = _cfg(t_config, scene_dir, experiment_dir=str(exp), BATCH_SIZE=1, **{key: value})
    if key == "data_parallel":
        a, b = spawn("main", 2, dict(cfg=cfg, resume_epochs=2), tmp_path, timeout=300)
        assert a["steps"] == b["steps"] == 1 and a["resumed_steps"] == b["resumed_steps"] == 2
        for k in a["state"]:
            assert torch.equal(a["state"][k], b["state"][k]), k
            assert torch.equal(a["resumed_state"][k], b["resumed_state"][k]), k
        assert _rank_outputs(exp) == ["code_log", "log.txt", "metrics.jsonl", "model"]
        log = (exp / "log.txt").read_text()
        assert "rank 0 of 2" in log and "rank 1 of 2" not in log
        assert "resumed from epoch 1" in log
        assert len((exp / "metrics.jsonl").read_text().splitlines()) == 4
        params, stats, epoch = CheckpointManager(str(exp / "model")).restore_eval()
        assert epoch == 2
        for k, v in a["resumed_state"].items():
            assert torch.equal(v, {**params, **stats}[k]), k
        return
    import torch.distributed as dist

    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    try:
        state = trainer.main(cfg, device="cpu")
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert state.step == 3 and not cfg.get("sync_bn")
    assert "rank 0 of 1" in (exp / "log.txt").read_text()
    assert sorted(p.name for p in (exp / "model").iterdir()) == ["1.pt", "metrics.json"]


def test_data_parallel_must_match_the_group(scene_dir, tmp_path, monkeypatch):
    """cfg.data_parallel that differs from the process group's size raises
    before anything is written (pcf_tpu's mesh takes that many devices)."""
    import torch.distributed as dist
    from torch_dist_worker import free_port

    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    cfg = _cfg(t_config, scene_dir, experiment_dir=str(tmp_path / "exp"), data_parallel=3)
    try:
        with pytest.raises(ValueError, match="data_parallel = 3"):
            trainer.main(cfg, device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert not (tmp_path / "exp").exists()


@pytest.mark.parametrize("mode", ["post_knn", "device_pyramid"])
def test_main_completes_each_batch_on_the_device(scene_dir, tmp_path, monkeypatch, mode):
    """main for one epoch under post_knn and device_pyramid: every train and
    validation batch goes through one prepare of the run (its graphs would
    outlive the epoch), comes out with the full pyramid and kNN edges, and
    the run trains, validates and checkpoints."""
    from pcf_torch.data import post_knn

    made, seen = [], []
    make = post_knn.make_prepare

    def recording_make(cfg):
        prep = make(cfg)

        def recorded(batch, device):
            out = prep(batch, device)
            seen.append((len(batch.points), out))
            return out

        made.append(recorded)
        return recorded

    monkeypatch.setattr(post_knn, "make_prepare", recording_make)
    exp = tmp_path / "exp"
    # these small scenes shrink less than the derived caps assume
    caps = {"device_level_caps": [1024, 512, 256]} if mode == "device_pyramid" else {}
    cfg = _cfg(t_config, scene_dir, experiment_dir=str(exp), **{mode: True}, **caps)
    state = trainer.main(cfg, device="cpu")
    assert state.step == 1 and len(made) == 1
    assert len(seen) == 3  # one train batch, two validation batches
    for levels_in, out in seen:
        assert levels_in == (3 if mode == "post_knn" else 1)
        assert len(out.points) == 3
        assert [e.shape[1] for e in out.edges_self] == [8, 8, 8]
        assert all(isinstance(e, torch.Tensor) for e in out.edges_forward)
    lines = [json.loads(x) for x in (exp / "metrics.jsonl").read_text().splitlines()]
    assert np.isfinite(lines[0]["train_loss"]) and "val_miou" in lines[1]
    assert sorted(p.name for p in (exp / "model").iterdir()) == ["1.pt", "metrics.json"]


def test_group_batches_matches_pcf_tpu():
    """Groups of one batch per device, the tail padded for validation or
    dropped for training, as pcf_tpu's _group_batches."""
    from pcf_tpu.train.trainer import _group_batches as j_group

    for group, pad in ((2, True), (2, False), (3, True), (1, False)):
        want = list(j_group(range(5), group, lambda b: b * 10, pad_tail=pad))
        assert list(trainer._group_batches(range(5), group, lambda b: b * 10,
                                           pad_tail=pad)) == want


# ---- evaluation --------------------------------------------------------------

def test_eval_io_bytes_match_pcf_tpu(tmp_path):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(70, 3)).astype(np.float32)
    labels = rng.integers(-1, 21, 70)
    for name, (jf, tf) in {"bin.ply": (lambda p: j_io.write_ply_color(p, pts, labels),
                                       lambda p: t_io.write_ply_color(p, pts, labels)),
                           "asc.ply": (lambda p: j_io.write_ply_color(p, pts, labels, False),
                                       lambda p: t_io.write_ply_color(p, pts, labels, False)),
                           "l.txt": (lambda p: j_io.write_labels_txt(p, labels),
                                     lambda p: t_io.write_labels_txt(p, labels))}.items():
        jf(str(tmp_path / f"j_{name}"))
        tf(str(tmp_path / f"t_{name}"))
        assert (tmp_path / f"j_{name}").read_bytes() == (tmp_path / f"t_{name}").read_bytes()
        if name.endswith(".ply"):
            for a, b in zip(j_io.read_ply(str(tmp_path / f"j_{name}")),
                            t_io.read_ply(str(tmp_path / f"t_{name}"))):
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(j_io.remap_20_to_nyu40(labels), t_io.remap_20_to_nyu40(labels))


def _miou(pred, labels):
    valid = labels >= 0
    inter = np.bincount(labels[valid & (pred == labels)], minlength=NCLS)[:NCLS]
    area = np.bincount(pred[valid], minlength=NCLS)[:NCLS] + np.bincount(
        labels[valid], minlength=NCLS)[:NCLS]
    return float(np.mean(inter / np.maximum(area - inter, 1)))


def test_simple_evaluate_matches_pcf_tpu(scene_dir, tmp_path, monkeypatch):
    """Both evaluations over the same 3 validation scenes (both pyramids on
    numpy/scipy), pcf_tpu's initial weights carried into the port."""
    _evaluate_against_pcf_tpu(scene_dir, tmp_path, monkeypatch)


def test_simple_evaluate_device_pyramid_matches_pcf_tpu(scene_dir, tmp_path, monkeypatch):
    """The same under device_pyramid: each scene's level 0 packed without
    windows, its pyramid and kNN (exact) built after packing."""
    _evaluate_against_pcf_tpu(scene_dir, tmp_path, monkeypatch, device_pyramid=True,
                              device_level_caps=[1024, 512, 256], knn_method="exact")


def _evaluate_against_pcf_tpu(scene_dir, tmp_path, monkeypatch, **kw):
    monkeypatch.setattr(j_pyramid, "_USE_NATIVE", False)
    monkeypatch.setattr(t_pyramid, "_USE_NATIVE", False)
    jc = _cfg(j_config, scene_dir, eval_path=str(tmp_path / "j"), **kw)
    tc = _cfg(t_config, scene_dir, eval_path=str(tmp_path / "t"), **kw)

    # the variables of the windowed model: the parameters are the same
    item = JDataset(_cfg(j_config, scene_dir), "validation", seed=jc.manual_seed)[0]
    b = j_pack([item], bucket_multiple=256, window_tile=128, window_sizes=jc.window_sizes)
    jmodel = JModel(jc)
    variables = jax.jit(lambda k: jmodel.init(
        k, b.feats, list(b.points), list(b.edges_self), list(b.edges_forward),
        list(b.edges_propagate), list(b.norms), masks=list(b.masks), train=False)
    )(jax.random.PRNGKey(0))
    # BN statistics away from their (0, 1) start, so that they matter
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda x: (x + rng.uniform(0.5, 1.5, x.shape)).astype(np.float32),
        variables["batch_stats"])
    tx, _ = j_optimizer(jc, 1)
    j_miou, _ = j_evaluate(jc, state=j_state(variables, tx))
    model = load_jax_variables(build(tc, device="cpu"), variables)
    t_miou, _ = t_evaluate(tc, state=model)

    preds, labels = {}, []
    for i in range(3):
        name = f"val_scene{i}"
        jp, tp = (np.load(tmp_path / s / f"{name}_probs.npy") for s in "jt")
        np.testing.assert_allclose(tp, jp, atol=1e-4, rtol=0)
        top2 = np.sort(jp, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > MARGIN
        jl, tl = (np.loadtxt(tmp_path / s / f"{name}.txt", dtype=np.int64) for s in "jt")
        np.testing.assert_array_equal(tl[sure], jl[sure])
        preds.setdefault("sure", []).append(sure)
        preds.setdefault("j", []).append(jp.argmax(-1))
        preds.setdefault("t", []).append(tp.argmax(-1))
        if sure.all():
            assert ((tmp_path / "j" / f"{name}.ply").read_bytes()
                    == (tmp_path / "t" / f"{name}.ply").read_bytes())
        item = JDataset(jc.copy(), "validation", seed=jc.manual_seed)[i]
        labels.append(np.asarray(item["label_list"]).astype(np.int64))
        assert len(item["point_list"]) == (1 if kw.get("device_pyramid") else 3)
    sure = np.concatenate(preds["sure"])
    assert sure.mean() > 0.5
    if sure.all():
        assert t_miou == pytest.approx(j_miou, abs=1e-12)
    else:
        lab = np.concatenate(labels)
        # the labels of pack order: the items' level-0 order is the batch's
        assert _miou(np.concatenate(preds["t"])[sure], lab[sure]) == pytest.approx(
            _miou(np.concatenate(preds["j"])[sure], lab[sure]), abs=1e-12)


def test_chip_smoke_phase13_config_is_synth_flagship(tmp_path):
    """chip_smoke.py loads the port's JSON copy of synth_flagship (the card's
    machine has no yaml): it equals pcf_tpu/configs/synth_flagship.yaml
    loaded by the port with the overrides listed in PERF.md."""
    data, exp = str(tmp_path / "data"), str(tmp_path / "exp")
    want = t_config.load_config(os.path.join(ROOT, "pcf_tpu", "configs", "synth_flagship.yaml"))
    want.update(USE_PALLAS_KERNEL=True, fused_min_points=0, resolve_impl="pallas",
                train_data_path=f"{data}/train/*.npz", val_data_path=f"{data}/val/*.npz",
                test_data_path=f"{data}/val/*.npz", experiment_dir=exp, total_epoches=1,
                eval_freq=1, save_freq=1,
                config=os.path.join(ROOT, "pcf_torch", "configs", "synth_flagship.json"))
    assert dict(chip_smoke.phase13_config(data, exp)) == dict(want)


def test_chip_smoke_phase14_config_is_post_knn_10cm(tmp_path):
    """chip_smoke.py loads the port's JSON copy of post_knn_10cm: it equals
    pcf_tpu/configs/post_knn_10cm.yaml loaded by the port with the overrides
    listed in PERF.md section 4."""
    data, exp = str(tmp_path / "data"), str(tmp_path / "exp")
    want = t_config.load_config(os.path.join(ROOT, "pcf_tpu", "configs", "post_knn_10cm.yaml"))
    want.update(USE_PALLAS_KERNEL=True, fused_min_points=0, pin_level_caps=True,
                level_caps_sample=8, level_caps_margin=1.15,
                train_data_path=f"{data}/train/*.npz", val_data_path=f"{data}/val/*.npz",
                test_data_path=f"{data}/val/*.npz", experiment_dir=exp,
                eval_path=f"{exp}/eval", total_epoches=1, eval_freq=1, save_freq=1,
                num_classes=8, classes=["wall", "floor", "ceiling", "table", "chair", "sofa",
                                        "cabinet", "clutter"],
                config=os.path.join(ROOT, "pcf_torch", "configs", "post_knn_10cm.json"))
    assert dict(chip_smoke.phase14_config(data, exp)) == dict(want)
