"""knn_replay_ms: the device's milliseconds of the device preparation's
graph replay (the program's span graphs.replay inside prepare,
data/post_knn.py: the kNN of every edge set; CUDA events on the stream),
per preparation call, over the traced steps."""

from perfbench.spans import device_ms_per_call, of


def read(t):
    spans = of(t)
    return device_ms_per_call(spans, "graphs.replay", "prepare") if spans else None
