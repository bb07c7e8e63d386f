"""step_device_ms.<loop>: the compiled step's time per call on the device
(parallel/graphs, parallel/mesh: the copy into the graph's inputs and its
replay), from CUDA events around each train or eval step call the
benchmark makes in the window; their mean."""


def read(t):
    if not t.step_ms:
        return None
    return sum(t.step_ms) / len(t.step_ms)
