"""prepare_host_ms: the host's milliseconds of each device preparation call
(the program's span prepare, data/post_knn.make_prepare: the key, the
graph's stage and replay launched, the copy of its outputs, the overflow
flag read back where there is one); their mean over the traced steps."""

from perfbench.spans import mean_host_ms, of


def read(t):
    spans = of(t)
    return mean_host_ms(spans, "prepare") if spans else None
