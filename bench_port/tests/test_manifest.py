"""BENCHMARK.json keeps to the benchmark's contract, and every cell finds
its configuration, traffic mix, limits and metric readers by name."""

import importlib
import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_paths_and_command():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert 1 <= len(SPEC["command"]) <= 32
    for word in SPEC["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]]
                         + [w["name"] for w in SPEC["workloads"]]
                         + [m["name"] for m in METRICS]
                         + [w["config"] for w in SPEC["workloads"]]
                         + [w["traffic"] for w in SPEC["workloads"]]
                         + [k for c in SPEC["configs"] for k in c["reduced"]])
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
        assert set(metric) <= allowed | {"bound"}
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert set(metric) <= allowed | {"layer", "moves"}
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", [])) <= cells


def test_unique_names():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_by_name(cell):
    from bench_port import run

    _, cfg, mix, limits, e2e, per_layer = run.resolve(SPEC, cell["name"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    assert cfg["name"] == cell["config"] and mix["name"] == cell["traffic"]
    assert importlib.import_module(f"bench_port.entries.{mix['entry']}").Entry
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per_layer
    for m in per_layer:
        assert callable(run.reader(m["name"]))


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entry(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"] and body["reduced"] == cfg["reduced"]
    assert len(cfg["reduced"]) <= 16
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
