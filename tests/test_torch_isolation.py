"""pcf_torch stands alone: no module of it (the native library's bindings,
the ScanNet pipeline, the device pyramid, the trainer, both evaluations and
the serving path among them), and nothing chip_smoke.py imports, loads jax,
flax, optax or pcf_tpu (nor, at import, yaml); entry points default to the
card and refuse to run without one; chip_smoke.py fails without the card or
without the repository."""

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
if {block_yaml!r}:
    sys.modules["yaml"] = None  # as on the card's machine: no PyYAML
import pcf_torch
for m in pkgutil.walk_packages(pcf_torch.__path__, "pcf_torch."):
    importlib.import_module(m.name)
import chip_smoke  # its module-level imports; main() needs the card
missing = [m for m in ("pcf_torch.native", "pcf_torch.data.scannet", "pcf_torch.data.prepare",
                       "pcf_torch.train.trainer", "pcf_torch.eval.simple", "pcf_torch.utils.cache",
                       "pcf_torch.ops.knn", "pcf_torch.data.post_knn", "pcf_torch.eval.voting",
                       "pcf_torch.serve.export", "pcf_torch.serve.predict",
                       "pcf_torch.parallel.spatial", "pcf_torch.nn.sharded")
           if m not in sys.modules]
assert not missing, missing
bad = sorted(n for n, m in sys.modules.items() if m is not None
             and n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "pcf_tpu", "yaml"))
assert not bad, bad
print("modules", sum(n.startswith("pcf_torch") for n in sys.modules))
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_jax_flax_or_pcf_tpu_loaded():
    r = _run(["-c", _IMPORT_ALL.format(root=ROOT, block_yaml=False)], ROOT)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 25, r.stdout


def test_every_module_imports_with_yaml_blocked():
    r = _run(["-c", _IMPORT_ALL.format(root=ROOT, block_yaml=True)], ROOT)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 25, r.stdout


def test_cli_arguments_and_overrides_without_yaml(tmp_path, monkeypatch):
    """The trainer's, eval.simple's and serve.export's argument parsing and
    load_config with --set values on a shipped JSON config, PyYAML blocked
    (the card's machine has none)."""
    from pcf_torch.config import load_config
    from pcf_torch.eval import simple
    from pcf_torch.serve import export
    from pcf_torch.train import trainer

    monkeypatch.setitem(sys.modules, "yaml", None)
    config = os.path.join(ROOT, "pcf_torch", "configs", "pcf_2cm_ptf2.json")
    sets = ["--set", f"train_data_path={tmp_path}/train/*.npz", "--set", "total_epoches=1",
            "--set", "learning_rate=1.0e-3", "--set", "level_caps=[49152, 24576, 8192]",
            "--set", "USE_PALLAS_KERNEL=yes", "--set", "note=1e-4", "--set", "optim.beta=~"]

    def held(cfg):
        assert cfg.config == config and cfg.accum_iter == 5 and cfg.mix3D is True
        assert cfg.train_data_path == f"{tmp_path}/train/*.npz" and cfg.total_epoches == 1
        assert cfg.learning_rate == 1e-3 and cfg.level_caps == [49152, 24576, 8192]
        assert cfg.USE_PALLAS_KERNEL is True and cfg.note == "1e-4"
        assert cfg.optim == {"beta": None}

    cfg, device = trainer.parse_args(["--config", config, *sets, "--device", "cpu"])
    held(cfg)
    assert device == "cpu"
    cfg, pretrain, split, device = simple.parse_args(
        ["--config", config, "--pretrain_path", str(tmp_path / "model"), *sets])
    held(cfg)
    assert (pretrain, split, device) == (str(tmp_path / "model"), "validation", None)
    a = export.parse_args(["--config", config, "--out", str(tmp_path / "art"), *sets,
                           "--platforms", "cpu"])
    held(load_config(a.config, a.overrides))
    assert a.platforms == "cpu" and a.out == str(tmp_path / "art")
    assert "yaml" not in {n for n, m in sys.modules.items() if m is not None}


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


@pytest.mark.parametrize("entry", ["ServingModel", "export CLI", "predict CLI"])
def test_serving_defaults_to_the_card(entry, tmp_path, monkeypatch):
    """Without a card the serving entry points raise unless asked for the
    CPU; asked for it, they get past the device (to the missing artifact)."""
    from pcf_torch.serve import export, predict

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    art, cfg = str(tmp_path / "artifact"), str(tmp_path / "missing.json")
    if entry == "ServingModel":
        card, cpu = (lambda: export.ServingModel(art)), (lambda: export.ServingModel(art, "cpu"))
    else:
        main = export.main if entry == "export CLI" else predict.main
        argv = (["export", "--config", cfg, "--out", art] if entry == "export CLI"
                else ["predict", "--artifact", art, "--scenes", str(tmp_path / "*.npz")])
        opt = ["--platforms", "cpu"] if entry == "export CLI" else ["--device", "cpu"]

        def run(args):
            monkeypatch.setattr(sys, "argv", args)
            main()

        card, cpu = (lambda: run(argv)), (lambda: run(argv + opt))
    with pytest.raises(RuntimeError, match="CUDA"):
        card()
    with pytest.raises(FileNotFoundError):
        cpu()


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    for cwd in (ROOT, str(tmp_path)):
        r = _run(["chip_smoke.py"], cwd)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
