"""BENCHMARK.json against the contract's shape, and every name in it found
by the harness: configurations, traffic mixes, limits, metric readers."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    conf = json.load(open(os.path.join(REPO, entry["file"])))
    assert conf["name"] == entry["name"]
    assert conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]
    assert set(conf["reduced"]) <= set(conf["why_set"])
    assert conf["peak_flops_per_s"] > 0
    confdir = os.path.join(BENCH, conf["conf"])
    for name in ("schema", "feature", "cross_feature", "model", "train",
                 "serving", "data_process"):
        assert os.path.exists(os.path.join(confdir, name + ".yaml"))
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    from harness import spec
    c = spec.Cell(cell)
    w = c.workload
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    assert c.traffic["kind"] == "train" and c.traffic["feed"] == "packed"
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e
    assert set(c.limits["train"]) == {"loss_gap", "grad_gap", "change_gap",
                                      "slot_gap"}


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    from harness import spec
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        return
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert "\n" not in metric["layer"]
    assert callable(spec.metric_reader(metric["name"]))
    for cell in metric["workloads"]:
        assert cell in CELLS


def test_pairs_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for key in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[key]]
        assert len(set(names)) == len(names)
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)


def test_files_under_paths_are_named_from_names():
    for root, _, files in os.walk(BENCH):
        if "__pycache__" in root:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), REPO)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
