"""Compiled steps on the card: one CUDA graph per step key, captured once.

pcf_tpu never runs a step eagerly. jax.jit compiles it once per input
signature and runs the compiled program after that: the train step at
pcf_tpu/parallel/mesh.py:125 and the eval step at :151 (:138 and :160 for
their mesh forms), the evaluation at pcf_tpu/eval/simple.py:61, and one
exported program per bucket in pcf_tpu/serve/export.py:67. StepGraphs stands
for the compile cache inside jax.jit. A step function keeps one, keyed on the
batch's signature (core/batching.PackedPyramid.signature) and on whatever
host state changes the program; serve/export.ServingModel keeps one for its
exported programs, keyed on the bucket, stamped with its parameters'
addresses.

The first call of a key:
  1. allocates static input buffers, a copy of the batch on the card;
  2. runs the step eagerly once, on the caller's stream. That builds the
     kernels (never inside a capture), fills state made at first use, such
     as the optimizer's, and is this call's result, as jax.jit's first call
     computes its result;
  3. captures the same body into a CUDA graph, with a memory pool of its
     own.
Every later call copies the batch into the static buffers and replays the
graph. Its outputs are the graph's static tensors, overwritten by the next
replay: the step function copies what it hands back. A capture that fails
raises; nothing on the card falls back to eager execution.

Pools: every graph has its own, since its static outputs (and a train
graph's gradients) stay live in it between replays; a capture reserves new
segments for it, so the memory reserved across a capture is its pool. Each
Compiled keeps its capture's time, its pool's size and the bytes live in
it. A graph's pool stays reserved while the graph lives, where jax.jit's
executables hold no memory between calls, and every new signature (a scene
packed under no level caps, an unpinned training batch) captures a new
graph. So a StepGraphs holds its graphs' pools to a budget, POOL_BUDGET_BYTES
or else a quarter of the card's memory: after a capture, the least recently used
graphs are dropped until the pools of those left fit it (the graph just
captured always stays). A dropped graph's pool goes back to the allocator,
and its signature is captured anew at its next call.

A graph reads every tensor that it did not allocate (weights, optimizer
state, the derived weights of ops/kernels/derived.py) at the address it had
at capture. So every call passes a `stamp` of those tensors beside its key,
and the graphs of a program captured under another stamp are dropped and
captured again at their next call. A train step stamps its weights'
addresses: its forward derives nothing from the weights outside the graph.
An eval step stamps its model's tensors as derived.stamp does (address and
_version): it reads derived weights made once, before its capture, and is
captured again exactly when derived.cached would make them again, after a
train step (which moves the _versions, derived.weights_written), a
train-mode forward (the BN running statistics), load_state_dict or a move.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from pcf_torch.core.batching import PackedPyramid

# the pools a StepGraphs may hold, in bytes; None: a quarter of the card's
# memory
POOL_BUDGET_BYTES: int | None = None


@dataclass
class Compiled:
    """One captured step: its graph, static input batch and static outputs,
    the objects it reads (kept alive with it), and what its capture cost."""

    graph: torch.cuda.CUDAGraph
    batch: PackedPyramid
    outputs: Any
    keep: tuple
    capture_ms: float
    pool_bytes: int
    live_bytes: int


class StepGraphs:
    """The graphs of one step function, by (program, signature): `program`
    is what the host reads besides the batch that changes the step (the
    model, its dtypes and options), `signature` the batch's. `captures`,
    `replays` and `evictions` (graphs dropped for the pool budget) count
    what the cache did."""

    def __init__(self):
        self.entries: dict = {}  # in order of last use, the most recent last
        self.stamps: dict = {}
        self.captures = 0
        self.replays = 0
        self.evictions = 0

    def run(self, program, signature, stamp, body: Callable[[PackedPyramid], Any],
            batch: PackedPyramid, device: torch.device,
            generator: torch.Generator | None = None, keep: tuple = ()) -> tuple[Any, bool]:
        """(outputs, replayed): body's outputs on `batch`, from a replay of
        the graph of (program, signature), or from the eager run of its
        first call, which then captures it. `stamp` says what the graph
        reads besides the batch (see the module); when it differs from the
        program's last one, every graph of the program is dropped.
        `generator` is one that body draws from; the caller seeds it before
        each call. `keep` holds what the graph reads (the model, the
        optimizer) while the graph lives."""
        entry = self.lookup(program, signature, stamp)
        if entry is not None:
            entry.batch.copy_(batch)
            entry.graph.replay()
            self.replays += 1
            return entry.outputs, True
        static = batch.to(device).clone()
        outputs = body(static)
        key = (program, signature)
        self.entries[key] = self._capture(body, static, device, generator, keep)
        self._fit_budget(key, device)
        return outputs, False

    def lookup(self, program, signature, stamp) -> Compiled | None:
        """The graph of (program, signature), if one was captured under
        `stamp`, now the most recently used; the program's graphs of another
        stamp are dropped."""
        if self.stamps.get(program) != stamp:
            self.entries = {k: v for k, v in self.entries.items() if k[0] != program}
            self.stamps[program] = stamp
        entry = self.entries.pop((program, signature), None)
        if entry is not None:
            self.entries[(program, signature)] = entry
        return entry

    def pool_bytes(self) -> int:
        """The memory reserved for the pools of the graphs held now."""
        return sum(e.pool_bytes for e in self.entries.values())

    @staticmethod
    def budget_bytes(device) -> int:
        """The pool budget on `device`: POOL_BUDGET_BYTES, or a quarter of
        the card's memory."""
        if POOL_BUDGET_BYTES is not None:
            return POOL_BUDGET_BYTES
        return torch.cuda.get_device_properties(device).total_memory // 4

    def _fit_budget(self, newest, device) -> None:
        """Drop the least recently used graphs, never `newest`, until the
        pools of those left fit the budget."""
        budget = self.budget_bytes(device)
        for key in list(self.entries):
            if self.pool_bytes() <= budget:
                break
            if key != newest:
                del self.entries[key]
                self.evictions += 1

    def _capture(self, body, static, device, generator, keep) -> Compiled:
        """Capture body(static) on a side stream into a graph with a pool of
        its own.

        cuBLAS keeps one workspace per stream for the whole process. It is
        dropped before the capture, so that the graph's matmuls take one made
        inside the capture, in the graph's own pool, and dropped after it, so
        that nothing else takes that memory while the graph lives
        (torch._inductor's CUDA graph trees do the same). Without this, one
        graph's matmuls used another's workspace: a train graph replayed after
        later captures read garbage (NaN weights), or crashed in
        cudaGraphLaunch once torch.cuda.empty_cache() had freed it, on the
        H100 (PERF.md, section 6). The capture does not go through
        torch.cuda.graph, which empties the allocator's cache first: nothing
        here needs the memory back."""
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        torch.cuda.synchronize(device)
        torch._C._cuda_clearCublasWorkspaces()
        reserved, allocated = (torch.cuda.memory_reserved(device),
                               torch.cuda.memory_allocated(device))
        t = time.perf_counter()
        with torch.cuda.stream(torch.cuda.Stream(device)):
            graph.capture_begin(pool=torch.cuda.graph_pool_handle())
            try:
                outputs = body(static)
            finally:
                graph.capture_end()
        torch.cuda.synchronize(device)
        torch._C._cuda_clearCublasWorkspaces()
        self.captures += 1
        return Compiled(graph, static, outputs, keep, (time.perf_counter() - t) * 1e3,
                        torch.cuda.memory_reserved(device) - reserved,
                        torch.cuda.memory_allocated(device) - allocated)
