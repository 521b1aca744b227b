"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's
root, and under ``niswan_bench/`` the configuration
(``configs/<config>.json``), the traffic mix (``traffic/<traffic>.json``,
naming its runner ``runners/<runner>.py``), the cell's limits of
``correct`` (``workloads/<cell>.json``) and one reader per per-layer
metric (``metrics/<metric>.py``)."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(BENCH_DIR / "configs" / f"{_name(name)}.json")


def traffic(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{_name(name)}.json")


def limits(cell_name: str) -> Dict[str, float]:
    path = BENCH_DIR / "workloads" / f"{_name(cell_name)}.json"
    return load_json(path)["limits"] if path.exists() else {}


def runner(kind: str) -> ModuleType:
    if not kind.isidentifier():
        raise ValueError(f"not a runner name: {kind!r}")
    return importlib.import_module(f"niswan_bench.runners.{kind}")


def reader(metric: str) -> ModuleType:
    path = BENCH_DIR / "metrics" / f"{_name(metric)}.py"
    spec = importlib.util.spec_from_file_location(
        "niswan_bench.metrics." + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reports(entry: dict, cell_name: str) -> bool:
    """Whether a metric entry is reported in a cell: every cell when it
    lists no workloads."""
    return "workloads" not in entry or cell_name in entry["workloads"]


def end_to_end(bench: dict, cell_name: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if reports(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> List[dict]:
    return [m for m in bench["per_layer"] if reports(m, cell_name)]
