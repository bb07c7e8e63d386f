"""The readers of the program's spans (perfbench/spans.py and the metrics
that read spans) on synthetic spans, a program without the recorder, the
idle gaps put down to spans, and a traced run at a tiny size on the CPU."""

import sys

import pytest

from perfbench import harness, spans as S


def _span(sid, parent, name, start_ms, end_ms, device_ms=None, root=None, **args):
    return {"id": sid, "parent": parent, "root": root or sid, "name": name,
            "start_ns": int(start_ms * 1e6), "end_ns": int(end_ms * 1e6), "args": args,
            "device_ms": (end_ms - start_ms) if device_ms is None else device_ms}


def _window(loop="train", capture=False):
    """Two calls of the window, each: the caller's copy-in (10 ms, 4 of them
    waiting), the device preparation (10 ms: key, stage 1 ms, replay 5 ms on
    the device, copy-out), the step (10 ms: key, stage 0.5 ms, replay 7 ms);
    with `capture`, the second step captures instead."""
    out, step = [], "step." + loop
    for c in range(2):
        t, i = 100 * c, 100 * c
        out += [_span(i + 1, None, "batch.to", t, t + 10, tensors=3, bytes=100),
                _span(i + 2, i + 1, "batch.to.wait", t, t + 4, root=i + 1),
                _span(i + 3, None, "prepare", t + 10, t + 20),
                _span(i + 4, i + 3, "step.key", t + 10, t + 11, root=i + 3),
                _span(i + 5, i + 3, "graphs.stage", t + 11, t + 12, 1.0, root=i + 3),
                _span(i + 6, i + 3, "graphs.replay", t + 12, t + 13, 5.0, root=i + 3),
                _span(i + 7, i + 3, "prepare.copy_out", t + 13, t + 14, root=i + 3),
                _span(i + 8, None, step, t + 20, t + 30),
                _span(i + 9, i + 8, "step.key", t + 20, t + 21, root=i + 8)]
        if capture and c == 1:
            out += [_span(i + 10, i + 8, "graphs.first_call", t + 21, t + 29, root=i + 8),
                    _span(i + 11, i + 10, "batch.to", t + 21, t + 22, root=i + 8),
                    _span(i + 12, i + 10, "graphs.capture", t + 22, t + 29, root=i + 8)]
        else:
            out += [_span(i + 10, i + 8, "graphs.stage", t + 21, t + 22, 0.5, root=i + 8),
                    _span(i + 11, i + 8, "graphs.replay", t + 22, t + 23, 7.0, root=i + 8)]
    return out


def _view(spans, loop="train"):
    t = harness.TraceView(loop=loop, dtype="float32", traced=None, window_s=1.0, steps=2,
                          step_ms=[], prep_ms=[], calls=[], step_flops=[])
    t.spans = spans
    return t


@pytest.mark.parametrize("metric,expected", [
    ("copy_in_ms.train", 6.0), ("step_host_ms.train", 10.0), ("stage_in_ms.train", 0.5),
    ("replay_ms.train", 7.0), ("prepare_host_ms", 10.0), ("knn_replay_ms", 5.0),
    ("graph_captures.train", 0)])
def test_reader_on_synthetic_spans(metric, expected):
    assert harness.reader(metric)(_view(_window())) == pytest.approx(expected)


@pytest.mark.parametrize("metric,expected", [
    ("step_host_ms.eval", 10.0), ("stage_in_ms.eval", 0.25), ("replay_ms.eval", 3.5),
    ("graph_captures.eval", 1)])
def test_reader_counts_every_call_and_capture(metric, expected):
    """Per call, a step that captured counts with no stage or replay; the
    step's own copy in its first call is no copy-in."""
    t = _view(_window("eval", capture=True), "eval")
    assert harness.reader(metric)(t) == pytest.approx(expected)
    assert harness.reader("copy_in_ms.train")(t) == pytest.approx(6.0)


@pytest.mark.parametrize("metric", ["copy_in_ms.train", "step_host_ms.train",
                                    "stage_in_ms.train", "replay_ms.train", "prepare_host_ms",
                                    "knn_replay_ms", "graph_captures.train"])
def test_reader_reads_nothing_without_the_recorder(metric, monkeypatch):
    """A program without pcf_torch/utils/trace.py (or one that recorded
    nothing): no value, and nothing raised."""
    monkeypatch.setitem(sys.modules, "pcf_torch.utils.trace", None)
    t = harness.TraceView(loop="train", dtype="float32", traced=None, window_s=1.0, steps=2,
                          step_ms=[], prep_ms=[], calls=[], step_flops=[])
    assert harness.reader(metric)(t) is None
    assert t.spans == []
    assert harness.reader(metric)(_view([])) is None


def test_idle_by_span_takes_the_innermost_open_span():
    spans = [_span(1, None, "step.train", 0, 100), _span(2, 1, "graphs.replay", 10, 50),
             _span(3, 2, "inner", 10, 20), _span(4, None, "prepare", 100, 120)]
    marks = [(0, int(200e6), "train_step"), (int(200e6), int(300e6), "copy_in")]
    gaps = [(int(ms * 1e6), int(length * 1e6)) for ms, length in
            [(60, 7), (15, 1), (20, 5), (110, 3), (150, 11), (250, 13), (400, 17), (65, 2)]]
    got = S.idle_by_span(gaps, spans, marks)
    want = {"inner": 0.001, "graphs.replay": 0.005, "step.train": 0.009, "prepare": 0.003,
            "train_step": 0.011, "copy_in": 0.013, "between calls": 0.017}
    assert got == pytest.approx(want)
    assert sum(got.values()) == pytest.approx(sum(g for _, g in gaps) / 1e9)


def test_traced_run_reads_the_programs_spans(tiny):
    """A traced run on the CPU (torch.profiler over the window, the recorder
    following it): the spans of the host side are read; the graphs' are
    not there (no graphs on the CPU), and no capture is counted."""
    out = harness.run(tiny("pcf10_train_devknn"), 2 ** 31 + 5, 2.0, True, device="cpu",
                      log=lambda m: None)
    m = out["result"]["metrics"]
    for name in ("copy_in_ms.train", "step_host_ms.train", "prepare_host_ms"):
        assert m[name]["value"] > 0 and m[name]["unit"] == "ms"
    assert m["graph_captures.train"]["value"] == 0
    assert not {"stage_in_ms.train", "replay_ms.train", "knn_replay_ms"} & set(m)
