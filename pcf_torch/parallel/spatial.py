"""Spatial (point-dimension) sharding: one packed batch's points across the
ranks (pcf_tpu/parallel/spatial.py).

For scenes whose activations exceed one card: every rank keeps its row shard
of the features and activations, and above all of the K-wide gathered
tensors and WeightNet intermediates (16x the feature maps at K=16).
Neighbour indices stay global. Each conv layer and each stage's geometry
all-gathers the tensors it gathers rows from, once per layer
(nn/sharded.sharded_points), so the results are the unsharded forward's up
to the order of the sums. Each rank holds the full gathered tables: memory
per rank is O(N), as in pcf_tpu.

A mesh (parallel/mesh.py) is a 1-D mesh, make_mesh(), whose ranks are all
space, or a (data, space) mesh, make_mesh_2d(D, S): rank r holds shard
r % S of the batch of data index r // S. The caller hands every rank the
batch of its data index, whole: the step shards it (shard_rows), after
checking that every level's capacity divides by S (_check_divisible, before
any collective) and unwrapping windowed edges to plain [M, K] ones
(_unwrap_windows). So kernels B and C run in `nei` mode on the shard's M
rows against tables of the full N rows; A, D and E are not on this path
(fused_eval is off under sharded points).

The eval step runs on the BN running statistics, with no BN collective, and
returns the full [N0, classes] logits on every rank (one last all-gather;
pcf_tpu's out_specs=P(sp_axis)). The train step is parallel/mesh.py's body
with `spatial`: SyncBN over every rank of the mesh, the loss summed over
the space axis (train/loss.py), the gradients summed over space and
averaged over data, the loss averaged over data, the IoU histograms summed
over every rank, and the dropout seed folded with the data index, then the
space index. As there, the optimizer rides in the TrainState, and on the
card under NCCL both steps run as CUDA graphs (parallel/graphs.StepGraphs),
keyed also on the mesh's shape; with gloo they run eagerly.
"""

from __future__ import annotations

from dataclasses import replace

import torch
import torch.distributed as dist

from pcf_torch.core.batching import PackedPyramid
from pcf_torch.nn.sharded import sharded_points
from pcf_torch.ops.window import WindowedEdges
from pcf_torch.parallel.mesh import Mesh, _captured_eval, _captured_train, _train_parts


def check_family(cfg) -> None:
    """pcf_tpu asserts the PCF layer family under spatial sharding."""
    if cfg.get("transformer_type", "PCF") != "PCF":
        raise NotImplementedError("spatial sharding is implemented for the PCF layer family")


def _check_divisible(batch: PackedPyramid, n: int) -> None:
    for lvl, pts in enumerate(batch.points):
        if pts.shape[0] % n:
            raise ValueError(f"level {lvl} cap {pts.shape[0]} not divisible by mesh size {n}; "
                             "pick bucket_multiple / level_caps divisible by the mesh")


def _unwrap_windows(batch: PackedPyramid) -> PackedPyramid:
    """The batch with every WindowedEdges replaced by its [M, K] indices."""
    def plain(edges):
        return tuple(e.nei if isinstance(e, WindowedEdges) else e for e in edges)

    return replace(batch, edges_self=plain(batch.edges_self),
                   edges_forward=plain(batch.edges_forward),
                   edges_propagate=plain(batch.edges_propagate))


def shard_rows(batch: PackedPyramid, n: int, i: int) -> PackedPyramid:
    """Shard i of n of every row-aligned tensor of `batch` (features, labels,
    and per level the points, normals, masks, scene ids and each edge
    array's rows), as views; the indices stay global."""
    return batch._map(lambda t: t.narrow(0, i * (t.shape[0] // n), t.shape[0] // n))


def _shard(mesh: Mesh):
    """prepare(batch) of the spatial steps: this rank's shard of the batch,
    its edges plain."""
    _, n, i, _, _ = mesh.space_axis()

    def prepare(batch: PackedPyramid) -> PackedPyramid:
        _check_divisible(batch, n)
        return shard_rows(_unwrap_windows(batch), n, i)

    return prepare


def make_spatial_eval_step(cfg, mesh: Mesh):
    """eval_step(state, batch) -> the full [N0, num_classes] logits of
    `batch`, its points sharded over the mesh's space axis (see the module).
    `state` is a TrainState or the model. `eval_step.graphs` is the
    StepGraphs."""
    check_family(cfg)
    group, n, _, _, _ = mesh.space_axis()

    def eager(model, batch):
        batch = batch.to(next(model.parameters()).device)
        model.eval()
        with torch.no_grad(), sharded_points(group):
            logits = model.forward_batch(batch)
        full = logits.new_empty((n * logits.shape[0],) + logits.shape[1:])
        dist.all_gather_into_tensor(full, logits.contiguous(), group=group)
        return full

    return _captured_eval(eager, mesh, prepare=_shard(mesh), tag=("spatial",) + mesh.shape)


def spatial_eval_forward(cfg, state, batch: PackedPyramid, mesh: Mesh):
    """One eval forward with the point dimension sharded over the mesh: the
    full logits. For repeated calls build the step once with
    make_spatial_eval_step."""
    return make_spatial_eval_step(cfg, mesh)(state, batch)


def make_spatial_train_step(cfg, mesh: Mesh, class_weights=None):
    """step(state, batch, seed) -> (state, metrics): one optimizer step on
    `batch` (the batch of this rank's data index), its points sharded over
    the mesh's space axis (see the module); the semantics of the unsharded
    step on one batch (a 1-D mesh), or of the data-parallel step with SyncBN
    over the data axis's batches (a 2-D mesh), up to the order of the sums.
    Afterwards each parameter's .grad holds this step's gradient.
    `step.graphs` is the StepGraphs."""
    check_family(cfg)
    return _captured_train(*_train_parts(cfg, class_weights, mesh, spatial=True), mesh,
                           prepare=_shard(mesh), tag=("spatial",) + mesh.shape)
