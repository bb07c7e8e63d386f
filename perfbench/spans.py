"""The program's own spans in a traced run (pcf_torch/utils/trace.py), for
the per-layer metrics that read them, and the device's idle gaps put down
to the span open when each began.

The program records spans while torch.profiler runs, which a `--trace 1`
run of perfbench/run.py does over the first `trace_steps` calls of its
window; the readers drain them once, after the window, and keep them on
the TraceView (`of`). On a program without the recorder they read nothing.

    python3 perfbench/spans.py --workload W --seed N --seconds S --trace 1

is perfbench/run.py with one more key in the result line's `breakdown`:
`idle_by_span`, the idle seconds of every gap between the device's
intervals in the traced steps, summed under the innermost program span
open at the gap's start, else under the harness's annotation open there,
else under "between calls" (`idle_by_span`). With `--spans-out FILE` it
also writes the spans, every gap of 0.1 ms or more with the innermost span
open at its start and at its end, and the harness's own CUDA-event times (`step_device_ms`,
`knn_ms`) over the traced calls alone, which the spans cover.
"""

from __future__ import annotations

import os
import sys

# the calls the window makes into the program; a span inside none of them
# is the caller's own (the harness's copy-in)
CALLS = ("step.train", "step.eval", "prepare")
STEP = {"train": "step.train", "eval": "step.eval"}


def of(t) -> list | None:
    """The spans the program recorded in t's traced window: drained from its
    recorder at the first call for t and kept on t. None where the program
    has no recorder or recorded nothing."""
    spans = getattr(t, "spans", None)
    if spans is None:
        try:
            from pcf_torch.utils import trace
        except ImportError:
            spans = []
        else:
            spans = trace.drain()
        t.spans = spans
    return spans or None


def host_ms(s: dict) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e6


def ancestors(spans: list) -> dict:
    """Each span's id -> the names of the spans around it, innermost first."""
    by_id = {s["id"]: s for s in spans}
    out = {}
    for s in spans:
        names, p = [], s["parent"]
        while p is not None and p in by_id:
            names.append(by_id[p]["name"])
            p = by_id[p]["parent"]
        out[s["id"]] = names
    return out


def inside(spans: list, name: str, outer) -> list:
    """The spans named `name` with a span named in `outer` around them."""
    up = ancestors(spans)
    return [s for s in spans if s["name"] == name and any(a in outer for a in up[s["id"]])]


def mean_host_ms(spans: list, name: str) -> float | None:
    """The mean host milliseconds of the spans named `name`."""
    ms = [host_ms(s) for s in spans if s["name"] == name]
    return sum(ms) / len(ms) if ms else None


def device_ms_per_call(spans: list, name: str, call: str) -> float | None:
    """The device milliseconds of the spans named `name` inside the calls
    named `call`, summed, over the number of those calls."""
    calls = sum(1 for s in spans if s["name"] == call)
    found = inside(spans, name, (call,))
    if not calls or not found:
        return None
    return sum(s["device_ms"] for s in found) / calls


def idle_by_span(gaps: list, spans: list, annotations: list) -> dict:
    """{name: idle seconds}: each gap (start_ns, length_ns) under the
    innermost span of `spans` open at its start (the latest begun, the
    shorter of two begun together), else the last-begun harness annotation
    (start_ns, end_ns, name) open there, else "between calls"."""
    order = sorted(spans, key=lambda s: (s["start_ns"], -s["end_ns"]))
    marks = sorted(annotations)
    out: dict = {}
    opened: list = []
    i = 0
    for at, length in sorted(gaps):
        while i < len(order) and order[i]["start_ns"] <= at:
            opened.append(order[i])
            i += 1
        opened = [s for s in opened if s["end_ns"] > at]
        if opened:
            key = opened[-1]["name"]
        else:
            held = [n for s, e, n in marks if s <= at < e]
            key = held[-1] if held else "between calls"
        out[key] = out.get(key, 0.0) + length / 1e9
    return out


def device_gaps(prof, annotations: tuple) -> tuple[list, list]:
    """(gaps, marks) of a finished torch.profiler profile, as
    harness.summarize takes them: the gaps (start_ns, length_ns) between
    the union of the device's intervals (the device-side copies of the
    harness's annotations left out), and the harness's annotations
    (start_ns, end_ns, name) on the host."""
    import torch

    dev, marks = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.name() not in annotations:
                dev.append((start, start + dur))
        elif e.name() in annotations and getattr(e, "is_user_annotation", lambda: False)():
            marks.append((start, start + dur, e.name()))
    dev.sort()
    gaps, cur_e = [], None
    for s, e in dev:
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s - cur_e))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps, marks


def innermost(spans: list, at: int) -> str | None:
    """The name of the innermost span open at `at` (ns), or None."""
    best = None
    for s in spans:
        if s["start_ns"] <= at < s["end_ns"] and (
                best is None or (s["start_ns"], -s["end_ns"]) > (best["start_ns"], -best["end_ns"])):
            best = s
    return best["name"] if best else None


def main(argv=None) -> int:
    """perfbench/run.py's run, its traced breakdown with idle_by_span."""
    import argparse
    import json

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from perfbench import harness, run

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--spans-out")
    own, rest = ap.parse_known_args(argv)
    seen = {}
    summarize, trace_view = harness.summarize, harness._trace_view

    def summarize_seen(prof, steps, wall_s):
        seen["gaps"], seen["marks"] = device_gaps(prof, harness.ANNOTATIONS)
        return summarize(prof, steps, wall_s)

    def trace_view_seen(*args, **kwargs):
        t = trace_view(*args, **kwargs)
        if not (t.traced and "gaps" in seen):
            return t
        spans = of(t) or []
        t.traced["breakdown"]["idle_by_span"] = idle_by_span(seen["gaps"], spans, seen["marks"])
        if own.spans_out:
            n = t.steps
            mean = (lambda v: sum(v) / len(v) if v else None)
            with open(own.spans_out, "w") as f:
                json.dump({"traced_calls": n, "step_device_ms": mean(t.step_ms[:n]),
                           "knn_ms": mean(t.prep_ms[:n]), "spans": spans,
                           "gaps": [[at, length, innermost(spans, at),
                                     innermost(spans, at + length)]
                                    for at, length in seen["gaps"] if length >= 100_000]}, f)
        return t

    harness.summarize, harness._trace_view = summarize_seen, trace_view_seen
    return run.main(rest)


if __name__ == "__main__":
    sys.exit(main())
