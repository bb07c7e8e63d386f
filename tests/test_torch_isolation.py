"""pcf_torch stands alone: no module of it (the native library's bindings,
the ScanNet pipeline, the device pyramid, the trainer and both evaluations
among them), and nothing chip_smoke.py imports, loads jax, flax, optax or
pcf_tpu (nor, at import, yaml); entry points default to the card and
refuse to run without one; chip_smoke.py fails without the card or without
the repository."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import pcf_torch
for m in pkgutil.walk_packages(pcf_torch.__path__, "pcf_torch."):
    importlib.import_module(m.name)
import chip_smoke  # its module-level imports; main() needs the card
missing = [m for m in ("pcf_torch.native", "pcf_torch.data.scannet", "pcf_torch.data.prepare",
                       "pcf_torch.train.trainer", "pcf_torch.eval.simple", "pcf_torch.utils.cache",
                       "pcf_torch.ops.knn", "pcf_torch.data.post_knn", "pcf_torch.eval.voting")
           if m not in sys.modules]
assert not missing, missing
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "pcf_tpu", "yaml"))
assert not bad, bad
print("modules", sum(n.startswith("pcf_torch") for n in sys.modules))
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_jax_flax_or_pcf_tpu_loaded():
    r = _run(["-c", _IMPORT_ALL.format(root=ROOT)], ROOT)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 25, r.stdout


def test_entry_points_default_to_the_card():
    from pcf_torch.config import Config, get_default_configs, get_default_training_cfgs
    from pcf_torch.entry import build, build_training, flagship_batch

    cfg = get_default_training_cfgs(get_default_configs(Config(), num_level=3, base_dim=8))
    cfg.update(guided_level=0, num_heads=2, resblocks=[0, 1, 1], mid_dim=[4, 4, 4],
               num_classes=5, milestones=[100], warmup_epochs=1)
    if torch.cuda.is_available():
        assert next(build(cfg).parameters()).device.type == "cuda"
        assert next(build_training(cfg)[0].model.parameters()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        build(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_training(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship_batch(level0_points=300, bucket=128)
    assert next(build(cfg, device="cpu").parameters()).device.type == "cpu"
    state, step = build_training(cfg, device="cpu")
    assert next(state.model.parameters()).device.type == "cpu" and state.step == 0
    assert callable(step)


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    for cwd in (ROOT, str(tmp_path)):
        r = _run(["chip_smoke.py"], cwd)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
