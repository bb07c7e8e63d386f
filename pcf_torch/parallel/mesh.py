"""The train and eval steps, on one device or data-parallel over a mesh.

The body of pcf_tpu/parallel/mesh.py's make_train_step and make_eval_step:
forward in train mode, loss, backward, clip and optimizer step
(train/state.py), the BN running statistics moved once by the forward, and
the metrics (loss and the IoU histograms), which stay on the device. The
model and its optimizer ride in the TrainState.

A mesh (make_mesh) is the port of pcf_tpu's 1-D "data" mesh: one process
per device in a torch.distributed process group (NCCL on the card, gloo on
the CPU), each holding a replica of the model and one packed batch, as a
device of pcf_tpu's shard_map holds one slice of stack_batches' stack (so
stack_batches has no counterpart here). Under a mesh the train step
averages the gradients over the ranks (pcf_tpu's pmean, :104: one
all_reduce over a flat buffer per dtype, inside the step, so that a CUDA
graph captures it), averages the loss and sums the IoU histograms over
them (:116-118, one all_reduce), draws dropout from the step's seed folded
with the rank (fold_in(rng, axis_index), :128), and, with cfg.bn_axis_name
set (trainer.build_mesh_and_cfg), sums every BatchNorm's masked statistics
over the ranks (nn/norm.synced_batch_stats, SyncBN). The eval step runs no
collective and returns the rank's own logits. make_mesh_2d lays the ranks
out as pcf_tpu's (data, space) mesh, for the spatial steps
(parallel/spatial.py), whose train step is this module's body with the
point dimension sharded (_train_parts' `spatial`).

On a CUDA model, make_train_step and make_eval_step run their step through
parallel/graphs.StepGraphs: one CUDA graph per key, captured at the key's
first call and replayed after that, as pcf_tpu's jax.jit compiles a step
once per signature. The key is the batch's signature, the model (and the
optimizer), the parameters' dtype, the model's cfg.compute_dtype,
cfg.fused_eval and cfg.flat_geom, and for the train step whether the update
ends an accumulation; beside it, the stamp of the tensors the graph reads
(graphs.py): for the train step its weights' addresses, for the eval step
their addresses and _versions. On the CPU, and under a mesh whose
collectives a CUDA graph cannot hold (gloo), they run the eager bodies,
make_eager_train_step and make_eager_eval_step, which are also the steps
that chip_smoke.py counts kernel launches in.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from pcf_torch.core.batching import PackedPyramid
from pcf_torch.nn.layers import set_generator
from pcf_torch.nn.norm import synced_batch_stats
from pcf_torch.nn.sharded import sharded_points
from pcf_torch.ops.kernels.derived import model_tensors, stamp, weights_written
from pcf_torch.ops.kernels.window_scatter import shared_inverses
from pcf_torch.parallel.graphs import StepGraphs
from pcf_torch.train.loss import cross_entropy_loss
from pcf_torch.train.metrics import intersection_and_union
from pcf_torch.train.state import TrainState


AXIS = "data"  # cfg.bn_axis_name under a mesh: pcf_tpu's mesh axis


@dataclass(frozen=True)
class Mesh:
    """The port's data mesh: this process's rank of `size` in `group` (the
    step's collectives), its device, and `control`, a gloo group over the
    same ranks on the host (the loops agree there on whether every rank has
    another batch, with no wait for the card). A 2-D mesh (make_mesh_2d)
    has `shape` (D, S), and this rank's `data` and `space` subgroups: the
    ranks of its space index and of its data index."""

    group: Any
    control: Any
    size: int
    rank: int
    device: torch.device
    shape: tuple = ()
    data: Any = None
    space: Any = None

    def space_axis(self) -> tuple:
        """(group, size, index) of the mesh's last axis, which the spatial
        steps shard the points over, and (size, index) of its data axis:
        a 1-D mesh is all space, one data index."""
        if len(self.shape) == 2:
            D, S = self.shape
            return self.space, S, self.rank % S, D, self.rank // S
        return self.group, self.size, self.rank, 1, 0


def make_mesh(n: int | None = None, device=None) -> Mesh:
    """The mesh over the initialised default process group (pcf_tpu's
    make_mesh over its devices): all of it, or `n` ranks, which must be all
    of it. A group of one rank is a mesh too: its collectives run and
    change nothing. `device`: this rank's device; default cuda:LOCAL_RANK
    for an NCCL group, else the CPU."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised torch.distributed process "
                           "group (torchrun, or init_process_group)")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n is not None and n != size:
        raise ValueError(f"a mesh of {n} ranks asked for in a group of {size}")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
                  if backend == "nccl" else torch.device("cpu"))
    control = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo")
    return Mesh(dist.group.WORLD, control, size, rank, torch.device(device), (size,))


def make_mesh_2d(data: int, space: int, device=None) -> Mesh:
    """A (data, space) mesh over the whole initialised process group, as
    pcf_tpu's Mesh(devices.reshape(data, space), ("data", "space")): rank r
    at data index r // space and space index r % space. Every rank creates
    every subgroup, in the same order (dist.new_group's rule), and keeps
    its own two."""
    base = make_mesh(data * space, device)
    spaces = [dist.new_group(list(range(d * space, (d + 1) * space))) for d in range(data)]
    datas = [dist.new_group(list(range(s, data * space, space))) for s in range(space)]
    return replace(base, shape=(data, space), data=datas[base.rank % space],
                   space=spaces[base.rank // space])


def all_have(mesh: Mesh | None, have: bool) -> bool:
    """Whether every rank of the mesh has `have` (one host collective on the
    control group; `have` itself without a mesh or with one rank)."""
    if mesh is None or mesh.size == 1:
        return have
    flag = torch.tensor([int(have)], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.control)
    return bool(flag.item())


def _mean_grads(grads: list, mesh: Mesh, div: int) -> None:
    """pcf_tpu's pmean of the gradients: summed over the mesh's ranks in one
    flat buffer per dtype, then divided by `div` (the data axis's size), in
    place."""
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(div)
        torch._foreach_copy_(same, [f.view_as(g) for f, g in
                                    zip(flat.split([g.numel() for g in same]), same)])


def _reduce_metrics(metrics: dict, mesh: Mesh) -> dict:
    """pcf_tpu's metrics under a mesh: the loss averaged, the histograms
    summed over the ranks, in one all_reduce."""
    names = ("intersection", "union", "target")
    flat = torch.cat([metrics["loss"].float().reshape(1)] + [metrics[k] for k in names])
    dist.all_reduce(flat, group=mesh.group)
    parts = flat.split([1] + [metrics[k].numel() for k in names])
    out = {"loss": (parts[0][0] / mesh.size).to(metrics["loss"].dtype)}
    out.update(zip(names, parts[1:]))
    return out


def step_seed(seed: int, index: int) -> int:
    """The seed of step `index` of a run seeded with `seed`: pcf_tpu's
    fold_in(PRNGKey(seed), index), as a 63-bit integer."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0] >> 1)


def _program_key(model) -> tuple:
    """What the host reads besides the batch that changes a step's program."""
    cfg = model.cfg
    return (id(model), next(model.parameters()).dtype, cfg.get("compute_dtype"),
            bool(cfg.get("fused_eval")), bool(cfg.get("flat_geom")))


def _train_parts(cfg, class_weights, mesh=None, spatial=False):
    """(body, seeded): body(model, tx, batch, generator, steps) -> (metrics,
    gradients) is the device work of one step, with the mesh's collectives;
    seeded(device, seed) is the step function's one generator for `device`,
    seeded with `seed` (folded with the rank under a mesh).

    `spatial` (parallel/spatial.py, pcf_tpu's make_spatial_train_step): the
    batch is this rank's shard of one batch's points, sharded over the
    mesh's space axis (Mesh.space_axis); the layers gather from full tables
    (nn/sharded.sharded_points), the loss sums over the space axis, SyncBN
    over every rank of the mesh, the gradients are summed over the ranks
    and divided by the data axis's size, and the seed is folded with the
    data index, then the space index."""
    num_classes = cfg.num_classes
    label_smoothing = float(cfg.label_smoothing or 0.0)
    ignore_label = cfg.ignore_label
    cw = None if class_weights is None else torch.as_tensor(class_weights,
                                                            dtype=torch.float32)
    per_device = {}
    bn_group = mesh.group if mesh is not None and cfg.get("bn_axis_name") else None
    points, grad_div, folds = None, 1 if mesh is None else mesh.size, ()
    if mesh is not None:
        folds = (mesh.rank,)
    if spatial:
        points, _, s, grad_div, d = mesh.space_axis()
        bn_group = mesh.group
        folds = (d, s) if len(mesh.shape) == 2 else (s,)

    def seeded(device, seed):
        for index in folds:
            seed = step_seed(seed, index)
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
        with synced_batch_stats(bn_group), sharded_points(points):
            logits = model.forward_batch(batch)
            loss, _ = cross_entropy_loss(
                logits, batch.labels, mask=batch.masks[0],
                class_weights=per_device[logits.device][1],
                label_smoothing=label_smoothing, ignore_label=ignore_label, group=points)
            with shared_inverses():  # kernel D inverts each edge set once
                loss.backward()
        if mesh is not None:
            _mean_grads([p.grad for p in tx.params if p.grad is not None], mesh, grad_div)
        tx.apply(steps)
        set_generator(model, None)
        with torch.no_grad():
            inter, union, target = intersection_and_union(
                logits.argmax(-1), batch.labels, num_classes, ignore_label,
                mask=batch.masks[0])
        metrics = {"loss": loss.detach(), "intersection": inter, "union": union,
                   "target": target}
        if mesh is not None:
            metrics = _reduce_metrics(metrics, mesh)
        return metrics, [p.grad for p in tx.params]

    return body, seeded


def _advance(state: TrainState) -> None:
    """The host's bookkeeping after a step: the counts, and the _version of
    every weight and BN statistic, which the step wrote in place unseen
    (a replay; torch's fused optimizers)."""
    state.tx.count += 1
    state.step += 1
    weights_written(model_tensors(state.model))


def _captures(device: torch.device, mesh: Mesh | None) -> bool:
    """Whether a step on `device` runs as CUDA graphs: on the card, where
    the mesh's collectives (if any) are NCCL's, which a graph can hold."""
    return device.type == "cuda" and (mesh is None or dist.get_backend(mesh.group) == "nccl")


def _eager_train(body, seeded):
    def step(state: TrainState, batch: PackedPyramid, seed: int):
        device = next(state.model.parameters()).device
        generator, _ = seeded(device, seed)
        metrics, _ = body(state.model, state.tx, batch.to(device), generator,
                          state.tx.begin())
        _advance(state)
        return state, metrics

    return step


def make_eager_train_step(cfg, mesh: Mesh | None = None, class_weights=None
                          ) -> Callable[[TrainState, PackedPyramid, int], tuple]:
    """step(state, batch, seed) -> (state, metrics): one optimizer step of
    state.model on `batch` (moved to the model's device), run op by op.
    Dropout and DropPath draw from a generator seeded with `seed` (under a
    mesh, step_seed(seed, rank)). Afterwards each parameter's .grad holds
    this step's gradient (averaged over the mesh's ranks)."""
    return _eager_train(*_train_parts(cfg, class_weights, mesh))


def make_train_step(cfg, mesh=None, class_weights=None
                    ) -> Callable[[TrainState, PackedPyramid, int], tuple]:
    """The step of make_eager_train_step, captured per key on a CUDA model
    (see the module). A replay leaves each parameter's .grad holding this
    step's raw gradient in the graph's own tensor, which the next replay
    overwrites; the metrics handed back are copies. `step.graphs` is the
    StepGraphs. Under a mesh the graph holds the step's collectives; its
    first call, eager, is the communicator's first use, as NCCL needs
    before a capture."""
    return _captured_train(*_train_parts(cfg, class_weights, mesh), mesh)


def _captured_train(body, seeded, mesh, prepare=None, tag=()):
    """make_train_step's step on body and seeded (_train_parts); `prepare`
    maps the caller's batch to the step's own (parallel/spatial.py: this
    rank's shard), and `tag` joins the graphs' program key."""
    eager = _eager_train(body, seeded)
    graphs = StepGraphs()

    def step(state: TrainState, batch: PackedPyramid, seed: int):
        if prepare is not None:
            batch = prepare(batch)
        model, tx = state.model, state.tx
        device = next(model.parameters()).device
        if not _captures(device, mesh):
            return eager(state, batch, seed)
        generator, _ = seeded(device, seed)
        steps = tx.begin()
        (metrics, grads), replayed = graphs.run(
            (_program_key(model), id(tx), steps) + tag, batch.signature(),
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


def make_eager_eval_step(cfg, mesh: Mesh | None = None
                         ) -> Callable[[TrainState, PackedPyramid], torch.Tensor]:
    """eval_step(state, batch) -> logits, with the BN running statistics, run
    op by op. `state` is a TrainState or the model itself. Under a mesh each
    rank evaluates its own batch and gets its own logits: there is nothing
    to reduce."""

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
    return _captured_eval(make_eager_eval_step(cfg, mesh), mesh)


def _captured_eval(eager, mesh, prepare=None, tag=()):
    """make_eval_step's step on the eager step `eager`; `prepare` and `tag`
    as _captured_train's."""
    graphs = StepGraphs()

    def eval_step(state, batch: PackedPyramid):
        if prepare is not None:
            batch = prepare(batch)
        model = getattr(state, "model", state)
        device = next(model.parameters()).device
        if not _captures(device, mesh):
            return eager(model, batch)
        logits, replayed = graphs.run(_program_key(model) + tag, batch.signature(),
                                      stamp(model_tensors(model)), lambda b: eager(model, b),
                                      batch, device, keep=(model,))
        return logits.clone() if replayed else logits

    eval_step.graphs = graphs
    return eval_step
