"""Experiment-dir utilities: code snapshot + metrics stream (the port of
pcf_tpu/utils/experiment.py).

Reference behavior: the trainer copies the config and key source files into
<experiment>/code_log/ for reproducibility (train_ScanNet_DDP_WarmUP.py:118-137)
and streams scalars to tensorboardX (:493-507). Here the snapshot covers the
config and the package source (not its built libraries); metrics stream to a
JSONL file always, and to TensorBoard where it is installed.
"""

from __future__ import annotations

import json
import os
import shutil
import time


def snapshot_code(exp_dir: str, config_path: str | None = None):
    """Copy the config file and pcf_torch/ (minus __pycache__, *.so and
    _build/) into <exp_dir>/code_log/, once."""
    code_dir = os.path.join(exp_dir, "code_log")
    os.makedirs(code_dir, exist_ok=True)
    if config_path and os.path.exists(config_path):
        shutil.copy2(config_path, code_dir)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(code_dir, "pcf_torch")
    if not os.path.exists(dst):
        shutil.copytree(pkg_root, dst,
                        ignore=shutil.ignore_patterns("__pycache__", "*.so", "_build"))


class MetricsWriter:
    """JSONL metrics stream + optional TensorBoard scalars."""

    def __init__(self, exp_dir: str, use_tensorboard: bool = False):
        os.makedirs(exp_dir, exist_ok=True)
        self._f = open(os.path.join(exp_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass  # tensorboard not installed; JSONL still records
            else:
                self._tb = SummaryWriter(os.path.join(exp_dir, "tb"))

    def write(self, step: int, **scalars):
        rec = {"step": step, "time": time.time(), **scalars}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
