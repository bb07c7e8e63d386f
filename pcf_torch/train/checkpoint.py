"""Checkpoint save and restore with torch.save / torch.load.

pcf_tpu/train/checkpoint.py's interface over files instead of Orbax:
<dir>/<epoch>.pt holds the step, the model's state_dict (parameters and BN
running statistics), the optimizer's state and the epoch's metrics, and
<dir>/metrics.json the metrics of every kept epoch, from which the best
(highest "miou") is found. At most `max_to_keep` checkpoints stay; the
oldest that is not the best goes first. A flax variable tree is imported
with pcf_torch.convert.load_jax_variables, not here.
"""

from __future__ import annotations

import json
import os

import torch

from pcf_torch.train.state import TrainState


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # a reader sees the old file or the whole new one


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._index_path = os.path.join(self.directory, "metrics.json")
        self._metrics = {}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._metrics = {int(k): v for k, v in json.load(f).items()}

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"{epoch}.pt")

    def save(self, epoch: int, state: TrainState, metrics: dict | None = None) -> None:
        model = state.model
        _atomic_save({"epoch": epoch, "step": state.step,
                      "model": model.state_dict(),
                      "params": [k for k, _ in model.named_parameters()],
                      "optimizer": state.tx.state_dict(),
                      "metrics": metrics or {}}, self._path(epoch))
        self._metrics[epoch] = metrics or {}
        best = self.best_epoch()
        while len(self._metrics) > self.max_to_keep:
            old = min(e for e in self._metrics if e != best)
            del self._metrics[old]
            os.remove(self._path(old))
        with open(self._index_path, "w") as f:
            json.dump(self._metrics, f)

    def _load(self, epoch: int | None):
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            return None
        return torch.load(self._path(epoch), map_location="cpu", weights_only=True)

    def restore(self, state_template: TrainState, epoch: int | None = None):
        """Load the latest (or the given) checkpoint into the template's
        model and optimizer; (state, epoch), or (template, 0) when none."""
        ck = self._load(epoch)
        if ck is None:
            return state_template, 0
        state_template.model.load_state_dict(ck["model"])
        state_template.tx.load_state_dict(ck["optimizer"])
        state_template.step = ck["step"]
        return state_template, ck["epoch"]

    def restore_eval(self, epoch: int | None = None):
        """(params, batch_stats, epoch) as state_dict pieces, read without
        an optimizer: the BN running statistics are batch_stats. (None,
        None, 0) when no checkpoint exists."""
        ck = self._load(epoch)
        if ck is None:
            return None, None, 0
        keys = set(ck["params"])
        params = {k: v for k, v in ck["model"].items() if k in keys}
        stats = {k: v for k, v in ck["model"].items() if k not in keys}
        return params, stats, ck["epoch"]

    def best_epoch(self):
        scored = [(m.get("miou", 0.0), e) for e, m in self._metrics.items()]
        return max(scored)[1] if scored else None

    def latest_epoch(self):
        return max(self._metrics) if self._metrics else None


def save_params_only(path: str, params: dict) -> None:
    """A bare parameter dump (the analog of a state_dict .pth)."""
    _atomic_save(dict(params), os.path.abspath(path))


def load_params_only(path: str, template: dict) -> dict:
    """The dump at `path`, holding exactly the keys and shapes of `template`."""
    params = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if set(params) != set(template):
        raise KeyError(f"{path}: keys differ from the template's: "
                       f"{sorted(set(params) ^ set(template))[:5]}")
    for k, v in template.items():
        if params[k].shape != v.shape:
            raise ValueError(f"{path}: {k} has shape {tuple(params[k].shape)}, "
                             f"the template {tuple(v.shape)}")
    return params
