"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import os
import re

import pytest

from portbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(core.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/")
        with open(os.path.join(core.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
            # a reduced key is a scale, stated beside the source's value
            assert cfg[k] < cfg["source_values"][k]
        assert set(cfg.get("source_values", {})) - {"why_reduced"} \
            == set(c["reduced"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == names


def test_workloads(bench):
    seen, pairs = set(), set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in seen
        seen.add(w["name"])
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(
            core.ROOT, "portbench", "traffic", w["traffic"] + ".json"))
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    names = set()
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e
    layers_by_name = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        layers_by_name.setdefault(m["layer"], set()).add(m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(
            core.ROOT, "portbench", "metrics", m["name"] + ".py"))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    cells = {w["name"] for w in bench["workloads"]}
    for w in cells:
        spec = core.load_cell(core.ROOT, w)
        got = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in got and len(got) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            # the cell reports the end-to-end metric this one moves
            assert m["moves"] in got
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_every_cell_loads(bench):
    for w in bench["workloads"]:
        spec = core.load_cell(core.ROOT, w["name"])
        loop = core.load_loop(core.ROOT, spec["traffic"]["loop"])
        for fn in ("setup", "window", "release", "check"):
            assert callable(getattr(loop, fn))
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert callable(core.load_reader(core.ROOT, m["name"]))
