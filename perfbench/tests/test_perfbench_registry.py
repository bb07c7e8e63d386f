"""BENCHMARK.json and the files it names: every configuration, traffic mix,
limit file and per-layer metric found by name, the file's shapes and limits, and
a later addition found by name without editing a file that is there."""

import json
import os
import re
import shutil

import pytest

from perfbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    b = bench()
    entries = b[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if section == "configs":
            assert set(e) == {"name", "source", "file", "reduced", "why"}
            assert e["file"].startswith("perfbench/") and len(e["reduced"]) <= 16
        elif section == "workloads":
            assert set(e) == {"name", "config", "traffic", "chips", "why"}
            assert e["chips"] == 1 and 1 <= len(e["why"]) <= 200
        else:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
        if section == "end_to_end":
            assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
            assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
        if section == "per_layer":
            assert set(e) <= {"name", "unit", "better", "source", "layer", "moves",
                              "workloads"}
            assert "workloads" in e


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_piece_of_a_cell_is_found_by_name(cell):
    b = bench()
    c = harness.find_cell(cell)
    assert c.meta["config"]["BATCH_SIZE"] == c.batch_size
    assert {"loop", "pyramid", "rooms_per_batch", "room_points", "pool_batches"} <= set(
        c.traffic)
    assert c.limits
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in c.per_layer:
        assert m["moves"] in e2e and m["moves"] in names
        assert callable(harness.reader(m["name"]))


def test_a_later_addition_is_found_by_name(tmp_path):
    """A new configuration, traffic mix, cell, limit file and per-layer
    metric, added as files and entries alone, are found by name."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    shutil.copy(root / "perfbench/configs/synth_flagship.json",
                root / "perfbench/configs/extra_cfg.json")
    (root / "perfbench/traffic/extra_mix.json").write_text(json.dumps(
        {"loop": "eval", "pyramid": "host", "rooms_per_batch": 2, "room_points": 1500,
         "room_seed_base": 5, "pool_batches": 2, "calibration_passes": 2}))
    (root / "perfbench/limits/extra_cell.json").write_text('{"logit_err": 0.5}')
    (root / "perfbench/metrics/extra_metric.py").write_text(
        "def read(t):\n    return 42.0 if t.loop == 'eval' else None\n")
    b["configs"].append({"name": "extra_cfg", "source": "https://example.org/x",
                         "file": "perfbench/configs/extra_cfg.json", "reduced": [],
                         "why": "a throwaway"})
    b["workloads"].append({"name": "extra_cell", "config": "extra_cfg",
                           "traffic": "extra_mix", "chips": 1, "why": "a throwaway"})
    b["per_layer"].append({"name": "extra_metric", "unit": "%", "better": "higher",
                           "source": "device_trace", "layer": "device",
                           "moves": "eval_points_per_s", "workloads": ["extra_cell"]})
    b["end_to_end"][[m["name"] for m in b["end_to_end"]].index(
        "eval_points_per_s")]["workloads"].append("extra_cell")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    c = harness.find_cell("extra_cell", root=str(root))
    assert c.batch_size == 2 and c.limits == {"logit_err": 0.5}
    assert [m["name"] for m in c.per_layer] == ["extra_metric"]
    assert "eval_points_per_s" in [m["name"] for m in c.end_to_end]
    read = harness.reader("extra_metric", root=str(root))
    assert read(type("T", (), {"loop": "eval"})()) == 42.0


def test_command_names_only_files_under_paths():
    b = bench()
    assert b["command"] == ["python3", "perfbench/run.py"]
    for word in b["command"][1:]:
        assert word.startswith("perfbench/") and ".." not in word
