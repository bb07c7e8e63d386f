"""knn_ms: the device preparation's time per call (the kNN of every edge
set on the card: data/post_knn, ops/knn), from CUDA events around each
preparation call the benchmark makes in the window; their mean."""


def read(t):
    if not t.prep_ms:
        return None
    return sum(t.prep_ms) / len(t.prep_ms)
