"""BENCHMARK.json against the shape its checker holds it to, and every file
it names in place: a cell's configuration, traffic and limits, and each
per-layer metric's reader."""

import json
import os
import re

import pytest

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert all(_line(w) for w in bench["command"])
    assert bench["paths"] == ["benchmark"]


def test_configs(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and c["file"].startswith("benchmark/")
        with open(os.path.join(REPO, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


def test_cells_and_their_files(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        for sub, name in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(REPO, "benchmark", sub,
                                               name + ".json"))


def test_metrics(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert _line(m["layer"]) and UNIT.match(m["unit"])
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics",
                                           m["name"] + ".py"))
