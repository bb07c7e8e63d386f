"""Weights derived for the kernels, kept between calls, and when they go stale.

Three caches keep a weight derived from model tensors: the bf16 copy of a
fused layer's L (pconv_fused._bf16_weight), kernel E's packed weights
(layer_eval.packed_weights) and the BatchNorm folds (nn/fused_eval._folded).
`cached` keys each entry on its source tensors' data_ptr and _version. An
eager in-place write (a BN running statistic, load_state_dict, an optimizer
of torch's that is not fused) moves the _version; a device or dtype move
gives new addresses.

Two writers move no _version: torch's fused optimizers, and a replayed CUDA
graph (parallel/graphs.py), which writes the weights while the host runs no
operator. Code that writes weights by such a route calls
`weights_written(tensors)` afterwards; the train steps and
train/state.Optimizer.update do. The eval graphs key on the same
(data_ptr, _version) of their model's tensors (`stamp`), so they are
captured again exactly when a cache entry would be made again.

While torch.export traces a forward (serve/export.py), the tensors are fake
and have neither an address nor a _version: `cached` then computes the value
from them on every call, so that the derivation is part of the exported
program and the program depends on its inputs alone.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import torch


def model_tensors(model: torch.nn.Module) -> list:
    """Every parameter and buffer of `model`, read from its modules' own
    dicts at each call, so that a replaced tensor is seen. The modules that
    hold any are listed once (a model's structure does not change), which
    makes this several times cheaper than model.parameters() and
    model.buffers(): an eval step stamps them at every call."""
    holders = model.__dict__.get("_pcf_holders")
    if holders is None:
        holders = [m for m in model.modules() if m._parameters or m._buffers]
        model.__dict__["_pcf_holders"] = holders
    return [t for m in holders for d in (m._parameters, m._buffers) for t in d.values()
            if t is not None]


def stamp(tensors: Iterable[torch.Tensor]) -> tuple:
    """What says that `tensors` still hold what a derived weight was made
    from: each one's address and _version."""
    return tuple((t.data_ptr(), t._version) for t in tensors)


def weights_written(tensors: Iterable[torch.Tensor]) -> None:
    """Move the _version of `tensors`, written in place by a route that does
    not (a fused optimizer, a graph replay). Host work only."""
    for t in tensors:
        torch.autograd.graph.increment_version(t)


def cached(owner: dict, slot, tensors: Sequence[torch.Tensor], compute: Callable):
    """compute()'s value (run without grad), kept in owner[slot] until the
    stamp of `tensors` changes. The entry holds the tensors' storages, so a
    replaced tensor cannot hand its address to a new one. While exporting it
    keeps nothing: compute() is traced into the program."""
    if torch.compiler.is_exporting():
        with torch.no_grad():
            return compute()
    key = stamp(tensors)
    hit = owner.get(slot)
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        value = compute()
    owner[slot] = (key, value, [t.untyped_storage() for t in tensors])
    return value
