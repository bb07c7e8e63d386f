"""The port's span recorder (pcf_torch/utils/trace.py) on the CPU: off it
records nothing, on it nests the spans of a step under one root with the
batch's counts, and its clock is torch.profiler's. The model and batch are
tests/test_torch_train.py's small windowed ones; nothing here imports
pcf_tpu."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from pcf_torch.config import Config, get_default_configs, get_default_training_cfgs
from pcf_torch.core import pack_scenes
from pcf_torch.data import scene_to_item, synthetic_scene
from pcf_torch.entry import build_training
from pcf_torch.parallel import graphs as graphs_mod, make_eval_step, mesh as mesh_mod
from pcf_torch.utils import trace

GRID = [0.3, 0.6, 1.2]


@pytest.fixture(scope="module")
def batch():
    c, n, f, l = synthetic_scene(250, extent=4.0, num_classes=5, seed=3)
    return pack_scenes([scene_to_item(c, n, f, l, GRID, 8, 8, 8,
                                      rng=np.random.default_rng(3), morton=True)],
                       bucket_multiple=128, window_tile=16, window_size=128)


@pytest.fixture(scope="module")
def training():
    cfg = get_default_training_cfgs(get_default_configs(Config(), num_level=3, base_dim=8))
    cfg.update(guided_level=0, num_heads=2, resblocks=[0, 1, 1], mid_dim=[4, 4, 4],
               grid_size=GRID, num_classes=5, USE_PE=True, USE_PALLAS_KERNEL=True,
               fused_min_points=0, resolve_impl="pallas", scheduler="MultiStepWithWarmup",
               milestones=[100], warmup_epochs=1, learning_rate=0.02)
    state, step = build_training(cfg, device="cpu")
    return cfg, state, step


@pytest.fixture
def recorder():
    trace.disable()
    trace.drain()
    yield trace
    trace.disable()
    trace.drain()


def test_off_records_nothing(recorder, batch, training):
    cfg, state, step = training
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b", device=True, n=1) is trace.OFF
    with trace.span("a") as s:
        assert not s
    step(state, batch.to("cpu"), 0)
    make_eval_step(cfg)(state, batch)
    assert trace.drain() == []


def _fake_capture(self, body, static, device, generator, keep):
    """A train step's 'graph' on the CPU: a replay that does nothing, and
    for outputs no metrics and zero gradients."""
    grads = [p.detach().new_zeros(p.shape) for p in keep[1].params]
    return graphs_mod.Compiled(SimpleNamespace(replay=lambda: None), static, ({}, grads),
                               keep, 0.0, 0, 0)


def test_step_spans_nest_under_one_root(recorder, batch, training, monkeypatch):
    """A captured train step's host side (graphs faked on the CPU): its first
    call and a replay, each inside a root the caller opens, as the window's
    copy-in and step."""
    cfg, state, step = training
    monkeypatch.setattr(mesh_mod, "_captures", lambda device, mesh: True)
    monkeypatch.setattr(graphs_mod.StepGraphs, "_capture", _fake_capture)
    monkeypatch.setattr(graphs_mod, "POOL_BUDGET_BYTES", 1 << 40)
    step.graphs.entries.clear()
    trace.enable()
    for i in range(2):
        with trace.span("window.step"):
            state, _ = step(state, batch.to("cpu"), i)
    spans = trace.drain()
    by_id = {s["id"]: s for s in spans}
    roots = [s for s in spans if s["name"] == "window.step"]
    assert len(roots) == 2 and all(s["parent"] is None and s["root"] == s["id"] for s in roots)

    def tree(root):
        out = []
        for s in sorted(spans, key=lambda s: s["start_ns"]):
            if s["root"] == root["id"] and s is not root:
                out.append((s["name"], by_id[s["parent"]]["name"]))
        return out

    assert tree(roots[0]) == [
        ("batch.to", "window.step"), ("step.train", "window.step"),
        ("step.key", "step.train"), ("graphs.first_call", "step.train"),
        ("batch.to", "graphs.first_call"), ("graphs.capture", "graphs.first_call")]
    assert tree(roots[1]) == [
        ("batch.to", "window.step"), ("step.train", "window.step"),
        ("step.key", "step.train"), ("graphs.stage", "step.train"),
        ("graphs.replay", "step.train")]
    tensors = batch.tensors()
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        assert s["device_ms"] == pytest.approx((s["end_ns"] - s["start_ns"]) / 1e6)
        if s["name"] == "batch.to":
            assert s["args"] == {"tensors": len(tensors), "bytes": nbytes}
        if s["name"] == "graphs.stage":
            assert s["args"] == {"bytes": nbytes}
    assert [s["args"] for s in spans if s["name"] == "graphs.first_call"] == [{"pool_bytes": 0}]


def test_spans_share_the_profilers_clock(recorder):
    """A span opened while torch.profiler runs is kept without enable(), and
    an annotation of the profiler's opened inside it lies within it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            with record_function("inside_outer"):
                time.sleep(0.002)
    assert not trace.enabled()
    (s,) = trace.drain()
    (e,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "inside_outer"]
    start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
    dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
    assert s["name"] == "outer" and dur >= 2e6
    assert s["start_ns"] - 1e6 <= start and start + dur <= s["end_ns"] + 1e6


def test_spans_of_threads_nest_apart(recorder):
    """Each thread nests its own spans: a span opened on another thread
    while one is open here is a root of its own."""
    import threading

    trace.enable()
    with trace.span("main"):
        th = threading.Thread(target=lambda: trace.span("other").__enter__().__exit__())
        th.start()
        th.join(timeout=10)
    assert not th.is_alive()
    spans = {s["name"]: s for s in trace.drain()}
    assert spans["other"]["parent"] is None and spans["other"]["root"] == spans["other"]["id"]
    assert spans["main"]["parent"] is None


def test_eval_step_spans(recorder, batch, training):
    """The eval step on the CPU runs eagerly inside its span, its copy of
    the batch to the model's device inside that."""
    cfg, state, _ = training
    trace.enable()
    make_eval_step(cfg)(state, batch)
    spans = sorted(trace.drain(), key=lambda s: s["start_ns"])
    assert [s["name"] for s in spans] == ["step.eval", "batch.to"]
    assert spans[0]["parent"] is None and spans[1]["parent"] == spans[0]["id"]
    assert spans[1]["root"] == spans[0]["id"]
