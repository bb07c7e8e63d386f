"""replay_ms.<loop>: the device's milliseconds of each step's graph replay
(the program's span graphs.replay inside step.train or step.eval,
parallel/graphs.py; CUDA events on the stream), per step call, over the
traced steps."""

from perfbench.spans import STEP, device_ms_per_call, of


def read(t):
    spans = of(t)
    return device_ms_per_call(spans, "graphs.replay", STEP[t.loop]) if spans else None
