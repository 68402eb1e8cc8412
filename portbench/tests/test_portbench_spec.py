r"""``BENCHMARK.json`` against the benchmark's contract, and every piece a
cell names found by its name: the configuration file, the traffic file
and its entry, each metric's reader, the cell's limits."""

import importlib
import json
import os
import re

import pytest

from conftest import ROOT

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_check_fits_its_time_with_every_cell():
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for x in SPEC["configs"] + SPEC["workloads"] + METRICS:
        assert NAME.match(x["name"]), x["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_pieces(cell):
    w = {x["name"]: x for x in SPEC["workloads"]}[cell]
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    cfg = {c["name"]: c for c in SPEC["configs"]}[w["config"]]
    assert os.path.exists(os.path.join(ROOT, cfg["file"]))
    traffic = json.load(open(os.path.join(ROOT, "portbench", "traffic",
                                          w["traffic"] + ".json")))
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    for fn in ("setup", "window", "release", "check"):
        assert callable(getattr(entry, fn))
    limits = json.load(open(os.path.join(ROOT, "portbench", "limits",
                                         cell + ".json")))
    from portbench.check import NUMBERS
    held = limits["limits"]
    assert held and set(held) <= set(NUMBERS)
    # each limit lies between the program's largest sound reading and the
    # control's smallest, which is three times it or more
    for k, v in held.items():
        lo, hi = limits["lower"][k], limits["upper"][k]
        assert hi >= 3 * lo and lo < v < hi, k
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if cell in m.get("workloads", CELLS)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell in m.get("workloads", CELLS) for m in SPEC["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_has_a_reader_and_a_sound_entry(metric):
    m = {x["name"]: x for x in METRICS}[metric]
    assert m["better"] in ("lower", "higher")
    assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])
    if m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in [x["name"] for x in SPEC["end_to_end"]]
        moved = {x["name"]: x for x in SPEC["end_to_end"]}[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS)
    for cell in m.get("workloads", []):
        assert cell in CELLS
    if metric != "setup_s":
        from portbench.harness import load_module
        assert callable(load_module("metrics", metric).read)


def test_configs_state_what_they_run():
    for c in SPEC["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["dtype"] in ("float32", "bfloat16")
        assert {"steady_step", "prescan", "where_stated"} <= set(
            cfg["arithmetic"])
        assert cfg["stacks"]["rnn4"]["hidden"] == 1280
