"""BENCHMARK.json against the benchmark contract's form: keys, names, units,
bounds, and that every part a cell names is a file the harness finds."""

import json
import re

import pytest

from niswan_bench.lib import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level():
    assert set(BENCH) == KEYS
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (spec.ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    assert all(not w.startswith("/") and ".." not in w for w in cmd)
    assert any(w.startswith(BENCH["paths"][0] + "/") for w in cmd)
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for w in BENCH["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in BENCH["configs"]:
        names += c["reduced"]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert len({c["name"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and line(c["source"]) and line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/") and len(c["reduced"]) <= 16
        assert json.loads((spec.ROOT / c["file"]).read_text())["name"] == c["name"]


def test_cells_find_their_parts():
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"])
        traffic = spec.traffic(w["traffic"])
        assert hasattr(spec.runner(traffic["runner"]), "Runner")
        limits = spec.limits(w["name"])
        assert limits and all(v > 0 for v in limits.values()), w["name"]


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e and 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert line(m["layer"]) and m["moves"] in e2e
        assert (spec.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        assert hasattr(spec.reader(m["name"]), "read")
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_what_it_must(cell):
    e2e = {m["name"] for m in spec.end_to_end(BENCH, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.per_layer(BENCH, cell)
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])
