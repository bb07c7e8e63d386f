"""The train and eval steps on one device.

The single-device body of pcf_tpu/parallel/mesh.py's make_train_step and
make_eval_step: forward in train mode, loss, backward, clip and optimizer
step (train/state.py), the BN running statistics moved once by the forward,
and the metrics (loss and the IoU histograms), which stay on the device.
The model and its optimizer ride in the TrainState. Data parallelism (a
mesh: DDP and SyncBN) waits for the parallel port and raises here.

On a CUDA model, make_train_step and make_eval_step run their step through
parallel/graphs.StepGraphs: one CUDA graph per key, captured at the key's
first call and replayed after that, as pcf_tpu's jax.jit compiles a step
once per signature. The key is the batch's signature, the model (and the
optimizer), the parameters' dtype, the model's cfg.compute_dtype,
cfg.fused_eval and cfg.flat_geom, and for the train step whether the update
ends an accumulation; beside it, the stamp of the tensors the graph reads
(graphs.py): for the train step its weights' addresses, for the eval step
their addresses and _versions. On the CPU they run
the eager bodies, make_eager_train_step and make_eager_eval_step, which are
also the steps that chip_smoke.py counts kernel launches in.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pcf_torch.core.batching import PackedPyramid
from pcf_torch.nn.layers import set_generator
from pcf_torch.ops.kernels.derived import model_tensors, stamp, weights_written
from pcf_torch.parallel.graphs import StepGraphs
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


def _program_key(model) -> tuple:
    """What the host reads besides the batch that changes a step's program."""
    cfg = model.cfg
    return (id(model), next(model.parameters()).dtype, cfg.get("compute_dtype"),
            bool(cfg.get("fused_eval")), bool(cfg.get("flat_geom")))


def _train_parts(cfg, class_weights):
    """(body, seeded): body(model, tx, batch, generator, steps) -> (metrics,
    gradients) is the device work of one step; seeded(device, seed) is the
    step function's one generator for `device`, seeded with `seed`."""
    num_classes = cfg.num_classes
    label_smoothing = float(cfg.label_smoothing or 0.0)
    ignore_label = cfg.ignore_label
    cw = None if class_weights is None else torch.as_tensor(class_weights,
                                                            dtype=torch.float32)
    per_device = {}

    def seeded(device, seed):
        if device not in per_device:
            per_device[device] = (torch.Generator(device),
                                  None if cw is None else cw.to(device))
        per_device[device][0].manual_seed(seed)
        return per_device[device]

    def body(model, tx, batch, generator, steps):
        model.train()
        set_generator(model, generator)
        for p in model.parameters():
            p.grad = None
        logits = model.forward_batch(batch)
        loss, _ = cross_entropy_loss(
            logits, batch.labels, mask=batch.masks[0],
            class_weights=per_device[logits.device][1],
            label_smoothing=label_smoothing, ignore_label=ignore_label)
        loss.backward()
        tx.apply(steps)
        set_generator(model, None)
        with torch.no_grad():
            inter, union, target = intersection_and_union(
                logits.argmax(-1), batch.labels, num_classes, ignore_label,
                mask=batch.masks[0])
        return ({"loss": loss.detach(), "intersection": inter, "union": union,
                 "target": target}, [p.grad for p in tx.params])

    return body, seeded


def _advance(state: TrainState) -> None:
    """The host's bookkeeping after a step: the counts, and the _version of
    every weight and BN statistic, which the step wrote in place unseen
    (a replay; torch's fused optimizers)."""
    state.tx.count += 1
    state.step += 1
    weights_written(model_tensors(state.model))


def _eager_train(body, seeded):
    def step(state: TrainState, batch: PackedPyramid, seed: int):
        device = next(state.model.parameters()).device
        generator, _ = seeded(device, seed)
        metrics, _ = body(state.model, state.tx, batch.to(device), generator,
                          state.tx.begin())
        _advance(state)
        return state, metrics

    return step


def make_eager_train_step(cfg, mesh=None, class_weights=None
                          ) -> Callable[[TrainState, PackedPyramid, int], tuple]:
    """step(state, batch, seed) -> (state, metrics): one optimizer step of
    state.model on `batch` (moved to the model's device), run op by op.
    Dropout and DropPath draw from a generator seeded with `seed`.
    Afterwards each parameter's .grad holds this step's raw gradient."""
    check_single_device(mesh)
    return _eager_train(*_train_parts(cfg, class_weights))


def make_train_step(cfg, mesh=None, class_weights=None
                    ) -> Callable[[TrainState, PackedPyramid, int], tuple]:
    """The step of make_eager_train_step, captured per key on a CUDA model
    (see the module). A replay leaves each parameter's .grad holding this
    step's raw gradient in the graph's own tensor, which the next replay
    overwrites; the metrics handed back are copies. `step.graphs` is the
    StepGraphs."""
    check_single_device(mesh)
    body, seeded = _train_parts(cfg, class_weights)
    eager = _eager_train(body, seeded)
    graphs = StepGraphs()

    def step(state: TrainState, batch: PackedPyramid, seed: int):
        model, tx = state.model, state.tx
        device = next(model.parameters()).device
        if device.type != "cuda":
            return eager(state, batch, seed)
        generator, _ = seeded(device, seed)
        steps = tx.begin()
        (metrics, grads), replayed = graphs.run(
            (_program_key(model), id(tx), steps), batch.signature(),
            tuple(t.data_ptr() for t in model_tensors(model)),
            lambda b: body(model, tx, b, generator, steps), batch, device,
            generator=generator, keep=(model, tx))
        for p, g in zip(tx.params, grads):
            p.grad = g
        if replayed:
            metrics = {k: v.clone() for k, v in metrics.items()}
        _advance(state)
        return state, metrics

    step.graphs = graphs
    return step


def make_eager_eval_step(cfg, mesh=None) -> Callable[[TrainState, PackedPyramid],
                                                     torch.Tensor]:
    """eval_step(state, batch) -> logits, with the BN running statistics, run
    op by op. `state` is a TrainState or the model itself."""
    check_single_device(mesh)

    def eval_step(state, batch: PackedPyramid):
        model = getattr(state, "model", state)
        batch = batch.to(next(model.parameters()).device)
        model.eval()
        with torch.no_grad():
            return model.forward_batch(batch)

    return eval_step


def make_eval_step(cfg, mesh=None) -> Callable[[TrainState, PackedPyramid], torch.Tensor]:
    """The step of make_eager_eval_step, captured per key on a CUDA model
    (see the module), for the standard, cfg.fused_eval and cfg.flat_geom
    forwards alike; the logits handed back are a copy. `eval_step.graphs`
    is the StepGraphs."""
    eager = make_eager_eval_step(cfg, mesh)
    graphs = StepGraphs()

    def eval_step(state, batch: PackedPyramid):
        model = getattr(state, "model", state)
        device = next(model.parameters()).device
        if device.type != "cuda":
            return eager(model, batch)
        logits, replayed = graphs.run(_program_key(model), batch.signature(),
                                      stamp(model_tensors(model)), lambda b: eager(model, b),
                                      batch, device, keep=(model,))
        return logits.clone() if replayed else logits

    eval_step.graphs = graphs
    return eval_step
