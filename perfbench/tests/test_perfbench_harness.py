"""Whole runs of the harness at a tiny size on the CPU (the card's look
skipped): sound runs come out correct, and each fault a cell can have,
planted under the timed path, turns `correct` false. Also the command's
refusals and its imports."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import harness

TRAIN_FAULTS = ["frozen_state", "half_batch"]
EVAL_FAULTS = ["half_batch", "altered_answer"]


def _run(cell, fault=None, trace=False):
    return harness.run(cell, 2 ** 31 + 3, 2.0, trace, device="cpu",
                       fault=fault, log=lambda m: None)


@pytest.mark.parametrize("name", ["pcf10_train_hostknn", "flagship_eval",
                                  "pcf10_train_devknn", "flagship_train"])
def test_sound_run_is_correct(tiny, name):
    out = _run(tiny(name))
    assert out["result"]["correct"], out["checks"]
    keys = list(out["result"])
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"


@pytest.mark.parametrize("name,fault", [(c, f) for c in ("pcf10_train_hostknn", "flagship_train")
                                        for f in TRAIN_FAULTS]
                         + [("flagship_eval", f) for f in EVAL_FAULTS])
def test_fault_turns_correct_false(tiny, name, fault):
    out = _run(tiny(name), fault)
    assert not out["result"]["correct"]


def test_traced_run_reads_per_layer_metrics(tiny):
    out = _run(tiny("pcf10_train_devknn"), trace=True)
    m = out["result"]["metrics"]
    assert {"knn_ms", "step_device_ms.train", "mfu.train"} <= set(m)
    assert "train_points_per_s" not in m
    assert out["result"]["device"]["window_s"] > 0


def test_command_refuses_without_a_card_or_the_program(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    args = ["--workload", "flagship_eval", "--seed", "1", "--seconds", "1", "--trace", "0"]
    r = subprocess.run([sys.executable, "perfbench/run.py"] + args, cwd=harness.ROOT,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    shutil.copytree(os.path.join(harness.ROOT, "perfbench"), tmp_path / "perfbench")
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    r = subprocess.run([sys.executable, "perfbench/run.py"] + args, cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_nothing_it_runs_loads_jax_or_pcf_tpu():
    """Every module the harness imports on a run's path, in a fresh
    process, by whole top-level name."""
    code = (
        "import sys; sys.path.insert(0, '.');"
        "import perfbench.run, perfbench.harness, perfbench.check, perfbench.calibrate;"
        "import perfbench.reference.flops, perfbench.weights, perfbench.rooms;"
        "import pcf_torch.models, pcf_torch.parallel.mesh, pcf_torch.data.post_knn;"
        "import pcf_torch.data.scannet, pcf_torch.utils.cache, pcf_torch.train.state;"
        "from perfbench import harness;"
        "[harness.reader(m['name']) for m in __import__('json').load("
        "open('BENCHMARK.json'))['per_layer']];"
        "print(harness.forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, USE_FLAX="0"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1].replace("'", '"')) == []


def test_restore_undoes_the_first_step_in_place(tiny):
    """Set-up's first train step (on the card the eager run and the
    capture) is undone in place: the parameters, buffers and optimizer
    state as before it, at the same addresses, so the step after it
    repeats the first step exactly."""
    import numpy as np
    import torch

    from pcf_torch.config import Config, get_default_configs, get_default_training_cfgs
    from pcf_torch.data.scannet import compute_weight
    from pcf_torch.models import PointConvFormer_Segmentation
    from pcf_torch.parallel.mesh import make_train_step, step_seed
    from pcf_torch.train.state import create_train_state, make_optimizer
    from perfbench import weights

    cell = tiny("pcf10_train_hostknn")
    cfg = Config.from_dict(cell.cfg)
    cfg = get_default_training_cfgs(get_default_configs(cfg, cfg.num_level, cfg.base_dim))
    scenes, room_seeds = harness.rooms(cell, 9)
    items = harness.program_items(cfg, scenes, room_seeds)
    batches, _ = harness.pack_pool(cfg, items, list(np.argsort(room_seeds)), cell.batch_size)
    model = PointConvFormer_Segmentation(cfg)
    weights.to_program(weights.draw(cell.cfg, 9, "cpu"), model)
    tx, _ = make_optimizer(cfg, 10)
    state = create_train_state(model, tx)
    step = make_train_step(cfg, class_weights=compute_weight([s[3] for s in scenes],
                                                             cfg.num_classes))
    tensors = list(model.parameters()) + list(model.buffers())
    before = [t.detach().clone() for t in tensors]
    addresses = [t.data_ptr() for t in tensors]

    state, first = step(state, batches[0], step_seed(9, 0))
    after_first = [p.detach().clone() for p in model.parameters()]
    held = [v.data_ptr() for p in tx.params for v in tx.inner.state[p].values()
            if isinstance(v, torch.Tensor)]
    harness._restore(state, before[:len(after_first)], before[len(after_first):])
    assert [t.data_ptr() for t in tensors] == addresses
    assert all(torch.equal(t, b) for t, b in zip(tensors, before))
    assert [v.data_ptr() for p in tx.params for v in tx.inner.state[p].values()
            if isinstance(v, torch.Tensor)] == held
    assert all(not v.any() for p in tx.params for v in tx.inner.state[p].values()
               if isinstance(v, torch.Tensor))
    assert tx.count == 0 and state.step == 0

    state, again = step(state, batches[0], step_seed(9, 0))
    assert float(again["loss"]) == float(first["loss"])
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), after_first))
