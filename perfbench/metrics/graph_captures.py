"""graph_captures.<loop>: the CUDA graphs the program captured in the
traced steps, its step's and its device preparation's together (the
program's span graphs.capture, parallel/graphs.StepGraphs._capture). A
window that captures pays a step's eager run and its capture inside it."""

from perfbench.spans import of


def read(t):
    spans = of(t)
    if not spans:
        return None
    return sum(1 for s in spans if s["name"] == "graphs.capture")
