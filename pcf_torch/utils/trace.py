"""Spans of the program's work, on the clock of torch.profiler's trace.

One recorder per process, off by default. enable() and disable() switch
it; it also records while a torch.profiler session runs in this process,
so that a profiled stretch of work carries the program's spans beside the
device trace, whoever started the profiler. span(name, device=False,
**args) opens one:

    with span("batch.to") as s:
        ...
        if s:
            s.args["bytes"] = n

Off, span() returns one shared object that does nothing and is false: it
allocates nothing and reads no clock, and a caller computes an argument
only where it is kept. On, each span keeps its `id`, its `parent` (the
innermost span open on its thread when it began, or None), its `root` (the
outermost one, or itself), `name`, `start_ns` and `end_ns` from
time.time_ns(), and `args`. torch.profiler stamps its host and device
events in the same Unix-epoch nanoseconds, so an idle gap of the device
trace can be put down to the span open when it began. With device=True and
CUDA present, a span also records a timing event on the current stream as
it opens and as it closes; drain() turns the pair into `device_ms`. Without
them `device_ms` is the host interval.

drain() hands back the finished spans and forgets them: nothing is written
while spans are recorded. The recorder annotates nothing in torch.profiler's
trace (no record_function): an annotation leaves a copy of itself on the
device timeline, which a reader of the device's busy time would count.

The spans the program opens, and what each covers:

    batch.to          core/batching.PackedPyramid.to; args tensors, bytes
    batch.to.wait     its wait for the work queued on the card before a copy
                      from the host (recorder on only)
    step.train        a train step (parallel/mesh), captured or eager
    step.eval         an eval step, captured or eager
    step.key          the key of a compiled step or preparation: program
                      key, batch signature, stamp
    graphs.stage      the batch copied into a graph's inputs; device; args bytes
    graphs.replay     a graph's replay; device
    graphs.first_call the eager run of a new key; args pool_bytes
    graphs.capture    its capture into a CUDA graph
    prepare           data/post_knn's device preparation of one batch
    prepare.copy_out  the copy of the preparation's outputs
    sync.overflow     the device pyramid's overflow flag read back
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import torch
from torch.autograd import profiler as _profiler

_on = False
_ids = itertools.count(1)
_done: deque = deque()  # finished spans: (record, start event, end event)
_open = threading.local()  # .stack: (id, root) of the spans open on this thread


class _Off:
    """What span() returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("record", "device", "events")

    def __init__(self, name: str, device: bool, args: dict):
        self.record = {"id": None, "parent": None, "root": None, "name": name,
                       "start_ns": None, "end_ns": None, "args": args}
        self.device = device
        self.events = None

    @property
    def args(self) -> dict:
        return self.record["args"]

    def __bool__(self):
        return True

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        rec = self.record
        rec["id"] = sid = next(_ids)
        if stack:
            rec["parent"], rec["root"] = stack[-1][0], stack[-1][1]
        else:
            rec["root"] = sid
        stack.append((sid, rec["root"]))
        if (self.device and torch.cuda.is_available()
                and not torch.cuda.is_current_stream_capturing()):
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        rec["start_ns"] = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.record["end_ns"] = time.time_ns()
        _open.stack.pop()
        _done.append((self.record, self.events))
        return False


def enable() -> None:
    """Record spans from now on."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording (a torch.profiler session still records); what was
    recorded stays until drain()."""
    global _on
    _on = False


def enabled() -> bool:
    """Whether span() records: after enable(), or while torch.profiler runs."""
    return _on or _profiler._is_profiler_enabled


def span(name: str, device: bool = False, **args):
    """A context manager for one span named `name` (see the module); the
    shared no-op OFF while the recorder is off."""
    if not (_on or _profiler._is_profiler_enabled):
        return OFF
    return _Span(name, device, args)


def drain() -> list[dict]:
    """The finished spans, in the order they closed, each with `device_ms`;
    the recorder forgets them. Waits for the device events of a span whose
    work is still queued."""
    out = []
    while True:
        try:
            rec, events = _done.popleft()
        except IndexError:
            return out
        if events is None:
            rec["device_ms"] = (rec["end_ns"] - rec["start_ns"]) / 1e6
        else:
            events[1].synchronize()
            rec["device_ms"] = events[0].elapsed_time(events[1])
        out.append(rec)
