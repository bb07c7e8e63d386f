"""The train and eval steps on one device.

The single-device body of pcf_tpu/parallel/mesh.py's make_train_step and
make_eval_step: forward in train mode, loss, backward, clip and optimizer
step (train/state.py), the BN running statistics moved once by the forward,
and the metrics (loss and the IoU histograms), which stay on the device.
The model and its optimizer ride in the TrainState. Data parallelism (a
mesh: DDP and SyncBN) waits for the parallel port and raises here.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pcf_torch.core.batching import PackedPyramid
from pcf_torch.nn.layers import set_generator
from pcf_torch.train.loss import cross_entropy_loss
from pcf_torch.train.metrics import intersection_and_union
from pcf_torch.train.state import TrainState


def check_single_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("a mesh (data-parallel training) is not ported to "
                                  "pcf_torch yet; pass mesh=None")


def step_seed(seed: int, index: int) -> int:
    """The seed of step `index` of a run seeded with `seed`: pcf_tpu's
    fold_in(PRNGKey(seed), index), as a 63-bit integer."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0] >> 1)


def make_train_step(cfg, mesh=None, class_weights=None
                    ) -> Callable[[TrainState, PackedPyramid, int], tuple]:
    """step(state, batch, seed) -> (state, metrics): one optimizer step of
    state.model on `batch` (moved to the model's device). Dropout and
    DropPath draw from a generator seeded with `seed`. Afterwards each
    parameter's .grad holds this step's raw gradient."""
    check_single_device(mesh)
    num_classes = cfg.num_classes
    label_smoothing = float(cfg.label_smoothing or 0.0)
    ignore_label = cfg.ignore_label
    cw = None if class_weights is None else torch.as_tensor(class_weights,
                                                            dtype=torch.float32)

    def step(state: TrainState, batch: PackedPyramid, seed: int):
        model = state.model
        device = next(model.parameters()).device
        batch = batch.to(device)
        model.train()
        set_generator(model, torch.Generator(device).manual_seed(seed))
        for p in model.parameters():
            p.grad = None
        logits = model.forward_batch(batch)
        loss, _ = cross_entropy_loss(
            logits, batch.labels, mask=batch.masks[0], class_weights=cw,
            label_smoothing=label_smoothing, ignore_label=ignore_label)
        loss.backward()
        state.tx.update()
        set_generator(model, None)
        with torch.no_grad():
            inter, union, target = intersection_and_union(
                logits.argmax(-1), batch.labels, num_classes, ignore_label,
                mask=batch.masks[0])
        state.step += 1
        return state, {"loss": loss.detach(), "intersection": inter, "union": union,
                       "target": target}

    return step


def make_eval_step(cfg, mesh=None) -> Callable[[TrainState, PackedPyramid], torch.Tensor]:
    """eval_step(state, batch) -> logits, with the BN running statistics."""
    check_single_device(mesh)

    def eval_step(state: TrainState, batch: PackedPyramid):
        model = state.model
        batch = batch.to(next(model.parameters()).device)
        model.eval()
        with torch.no_grad():
            return model.forward_batch(batch)

    return eval_step
