"""The plain reference against the program on the CPU at a tiny size, and
the reference's independence of the program."""

import ast
import os

import numpy as np
import pytest
import torch

from perfbench import check, harness, weights
from perfbench.reference import pyramid as rp
from perfbench.reference.model import Precision, Segmentation

REF_DIR = os.path.join(harness.ROOT, "perfbench", "reference")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(REF_DIR) if f.endswith(".py")))
def test_reference_imports_nothing_of_the_program(name):
    tops = {m.split(".")[0] for m in _imports(os.path.join(REF_DIR, name))}
    assert not tops & {"pcf_torch", "pcf_tpu", "jax", "jaxlib", "flax"}, tops


@pytest.mark.parametrize("cell_name", ["pcf10_train_hostknn", "flagship_eval"])
def test_forward_matches_the_program_on_the_cpu(tiny, cell_name):
    """Training-mode logits of one batch: the program's eager forward (the
    kernels' plain versions) and the reference's, rows matched."""
    from pcf_torch.config import Config, get_default_configs, get_default_training_cfgs
    from pcf_torch.models import PointConvFormer_Segmentation
    from pcf_torch.nn.layers import set_generator

    cell = tiny(cell_name)
    cfg = get_default_training_cfgs(get_default_configs(Config.from_dict(cell.cfg), 3, 32))
    cfg.compute_dtype = "float32"
    scenes, seeds = harness.rooms(cell, 9)
    items = harness.program_items(cfg, scenes, seeds)
    batches, _ = harness.pack_pool(cfg, items, list(np.argsort(seeds)), cell.batch_size)
    w = weights.draw(cell.cfg, 9, "cpu")
    prog = PointConvFormer_Segmentation(cfg).train()
    weights.to_program(w, prog)
    set_generator(prog, torch.Generator())
    ref = Segmentation(cell.cfg).train()
    weights.load_reference(w, ref)
    sc = scenes[:cell.batch_size]
    with torch.no_grad():
        got = prog.forward_batch(batches[0])
        want = ref(rp.scene_set(sc, cell.cfg["grid_size"], check._ks(cell.cfg), "cpu"))
    pr, rr = check.level0_order(batches[0], sc)
    scale = float(want.abs().max())
    assert float((got[pr] - want[rr]).abs().max()) <= 1e-4 * scale


def _program_readings(cell, seed, device):
    return harness.run(cell, seed, 0.5, False, device=device, log=lambda m: None)["readings"]


def test_fp8_control_is_caught(tiny):
    """The bf16 cells' control, the reference with float8 operands in the
    program's place, reads at least three times what the program reads on
    the same rooms and weights, at a tiny size on the CPU (the limits
    themselves are set at the cell's own size on the card)."""
    cell = tiny("flagship_eval")
    seed = 4
    prog = _program_readings(cell, seed, "cpu")
    scenes, _ = harness.rooms(cell, seed)
    w = weights.draw(cell.cfg, seed, "cpu")
    ref = check.reference_eval(cell, scenes, w, "cpu")
    ctl = check.reference_eval(cell, scenes, w, "cpu", prec=Precision("fp8"))
    worst = {}
    for b in ref:
        got = check.eval_gaps(ctl[b], ctl[b].argmax(-1), ref[b])
        worst = {k: max(worst.get(k, 0.0), v) for k, v in got.items()}
    assert any(worst[k] >= 3 * prog[k] for k in ("logit_rms", "pred_gap")), (worst, prog)


@pytest.mark.gpu
def test_tf32_control_is_caught(tiny, card):
    """The f32 cells' control, the reference with TF32 matrix products in
    the program's place, against the program's readings on the card."""
    cell = tiny("pcf10_train_hostknn")
    seed = 4
    prog = _program_readings(cell, seed, card)
    scenes, _ = harness.rooms(cell, seed)
    w = weights.draw(cell.cfg, seed, card)
    ref = check.reference_train(cell, scenes, w, card)
    ctl = check.train_numbers(check.reference_train(cell, scenes, w, card, tf32=True), ref, w)
    assert any(ctl[k] >= 3 * prog[k] for k in ("bn_stat_gap", "grad_gap_median")), (ctl, prog)
