"""copy_in_ms.<loop>: the host's milliseconds of each copy of a batch to
the card that the window makes itself (the program's span batch.to,
core/batching.PackedPyramid.to, outside any step or preparation), less its
wait for the card's queued work (its span batch.to.wait); their mean over
the traced steps."""

from perfbench.spans import CALLS, ancestors, host_ms, of


def read(t):
    spans = of(t)
    if not spans:
        return None
    up = ancestors(spans)
    copies = [s for s in spans
              if s["name"] == "batch.to" and not any(a in CALLS for a in up[s["id"]])]
    if not copies:
        return None
    waits = {s["parent"]: host_ms(s) for s in spans if s["name"] == "batch.to.wait"}
    return sum(host_ms(s) - waits.get(s["id"], 0.0) for s in copies) / len(copies)
