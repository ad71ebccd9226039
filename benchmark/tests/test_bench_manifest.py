"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by its name."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark.tests import tiny

ROOT = tiny.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def man():
    return tiny.manifest()


def test_top_level_keys_and_size(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    assert 1 <= len(man["command"]) <= 32
    assert all(LINE.match(w) for w in man["command"])
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    assert not man["paths"][0].endswith("_torch")


def test_names_units_and_keys(man):
    seen = set()
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(man["paths"][0] + "/")
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        assert m["moves"] in {e["name"] for e in man["end_to_end"]}
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}
    names = [x["name"] for x in man["workloads"]]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_cell_reports_its_metrics(man):
    """Each cell: set-up, one more end-to-end metric, one per-layer metric;
    a per-layer metric's cells report the metric it moves."""
    for w in man["workloads"]:
        e2e = [m["name"] for m in man["end_to_end"]
               if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        pl = [m for m in man["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert pl
        for m in pl:
            assert m["moves"] in e2e


def test_files_found_by_name(man):
    cfgs = {c["name"]: c for c in man["configs"]}
    for w in man["workloads"]:
        cfg = cfgs[w["config"]]
        with open(os.path.join(ROOT, cfg["file"])) as f:
            config = json.load(f)
        assert {"model", "data", "train", "limits", "peak"} <= set(config)
        with open(os.path.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json")) as f:
            mix = json.load(f)
        assert os.path.exists(os.path.join(ROOT, "benchmark", "drivers", mix["kind"] + ".py"))
        assert mix["kind"] in config["limits"]
        assert mix["metric"] in {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
