"""step_host_ms.<loop>: the host's milliseconds of each train or eval step
call (the program's span step.train or step.eval, parallel/mesh.py: the
key, the graph's stage and replay launched, the outputs handed back);
their mean over the traced steps."""

from perfbench.spans import STEP, mean_host_ms, of


def read(t):
    spans = of(t)
    return mean_host_ms(spans, STEP[t.loop]) if spans else None
