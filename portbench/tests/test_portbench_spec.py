"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import json
import re

import pytest

from portbench import cell as cells
from portbench.lanes import DEFAULT as DEFAULT_LANE

from .conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k]


def test_metric_entries():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], []).append(m["name"])
    assert layers


def _holds(d: dict, keys) -> None:
    """Each of ``keys`` in ``d``, and every number among them above 0."""
    for k in keys:
        assert k in d, (d.get("name"), k)
        if isinstance(d[k], (int, float)):
            assert d[k] > 0, (d.get("name"), k)


@pytest.mark.parametrize("w", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(w):
    cell = cells.load_cell(ROOT, w)
    _holds(cell.traffic, cell.lane.TRAFFIC_KEYS)
    assert "setup_s" in cell.metrics and len(cell.metrics) >= 2
    assert cell.traced_metrics
    for name in list(cell.metrics) + list(cell.traced_metrics):
        assert callable(cells.reader(ROOT, name))


def test_config_files_hold_source_reduced_assumed():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        for k in ("source", "deployment", "reduced", "assumed",
                  "guarantees"):
            assert k in cfg, (c["name"], k)
        assert c["file"].startswith("portbench/configs/")


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files_hold_their_lanes_keys(c):
    """Each configuration holds the keys its lane reads; the lane's file
    gives what ``lanes/__init__.py`` asks of a lane."""
    cfg = json.loads((ROOT / c["file"]).read_text())
    lane = cells.load_lane(ROOT, cfg.get("lane", DEFAULT_LANE))
    for attr in ("CONFIG_KEYS", "TRAFFIC_KEYS", "Recording", "Run",
                 "PHASES", "KERNEL", "SUMS", "slices", "extras"):
        assert hasattr(lane, attr), (c["name"], attr)
    _holds(cfg, lane.CONFIG_KEYS)


def test_array_lane_reads_what_the_array_configs_held():
    from portbench.lanes import array

    assert set(array.CONFIG_KEYS) == {"docs", "messages", "clients",
                                      "capacity", "sessions", "steps", "mix"}
    assert array.TRAFFIC_KEYS == ("messages_per_round",)
    assert array.KERNEL == ("b1", "merge_window")


def test_split_metric_falls_back_to_its_quantity_reader():
    assert cells.reader(ROOT, "b1_roofline.any_cell") is not None
    with pytest.raises(FileNotFoundError):
        cells.reader(ROOT, "no_such_quantity.x")


def test_added_cell_needs_no_code_edit(tiny_root):
    cell = cells.load_cell(tiny_root, "tiny.r16")
    assert cell.config["docs"] == 6 and "rounds_per_s" in cell.traced_metrics
    assert "rounds_per_s" not in cells.load_cell(
        tiny_root, "string16c.typing").traced_metrics
    assert cells.reader(tiny_root, "rounds_per_s")


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.load_cell(ROOT, "no.such.cell")


def test_every_listed_cell_reports_what_a_layer_metric_moves():
    """A per-layer metric's ``moves`` is an end-to-end metric of every
    cell it lists: with ``ops_per_s`` split by configuration, so are the
    per-layer metrics."""
    for m in SPEC["per_layer"]:
        for w in m.get("workloads", [w["name"] for w in SPEC["workloads"]]):
            assert m["moves"] in cells.load_cell(ROOT, w).metrics, (m, w)
