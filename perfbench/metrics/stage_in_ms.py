"""stage_in_ms.<loop>: the device's milliseconds of the copy of each step's
batch into its graph's inputs (the program's span graphs.stage inside
step.train or step.eval, parallel/graphs.py; CUDA events on the stream),
per step call, over the traced steps."""

from perfbench.spans import STEP, device_ms_per_call, of


def read(t):
    spans = of(t)
    return device_ms_per_call(spans, "graphs.stage", STEP[t.loop]) if spans else None
