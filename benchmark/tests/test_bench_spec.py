"""BENCHMARK.json against its format: its keys, every name and unit
against the allowed characters, the limits on sizes and bounds, and
every file the harness finds by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
METRIC_KEYS = {"end_to_end": {"name", "unit", "better", "bound", "source"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves"}}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(SPEC) == TOP
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(line(w) for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(harness.ROOT, p))
    for w in SPEC["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in SPEC["paths"])


def test_run_seconds_fit_a_full_check_of_24_cells():
    r = SPEC["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_are_unique_and_allowed(group):
    names = [e["name"] for e in SPEC[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        assert set(c["reduced"]) == set(cfg["reduced"])
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg
            assert not k.endswith(("_dim", "_rank"))
        assert os.path.exists(os.path.join(
            harness.HERE, "problems", cfg["problem"] + ".py"))
        assert set(cfg["checks"]) and all(v >= 0 for v in
                                          cfg["checks"].values())


def test_workloads():
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4) and line(w["why"])
        traffic = os.path.join(harness.HERE, "traffic",
                               w["traffic"] + ".json")
        with open(traffic) as f:
            t = json.load(f)
        assert {"batch", "pool", "warmup_calls", "trace_calls"} <= set(t)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(group):
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC[group]:
        assert set(m) - {"workloads"} == METRIC_KEYS[group]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py"))
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(SPEC, w["name"], 0)]
        per = [m for m in harness.cell_metrics(SPEC, w["name"], 1)]
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        for m in per:
            assert m["moves"] in e2e


def test_setup_bound():
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
