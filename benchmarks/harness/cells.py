"""Resolve a cell of ``BENCHMARK.json`` to the files that define it.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one per-layer metric lives in a file of its own, found by name:

    benchmarks/configs/<config>.json    the scenario and its source
    benchmarks/traffic/<traffic>.json   the parameters of the load history
    benchmarks/limits/<cell>.json       the limits of the comparison
    benchmarks/metrics/<metric>.py      the reader of a per-layer metric
    benchmarks/reference/materials/<config>.py
                                        the configuration's own material
                                        layout, where it has more than one
                                        material (optional)

so a later change adds a configuration, a mix, a cell or a metric by adding
files and entries, without editing one that is there.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict  # the traffic file
    limits: dict  # the limits file
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def _load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_benchmark(root: Path = ROOT) -> dict:
    return _load_json(root / "BENCHMARK.json")


def resolve(workload: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(known: {', '.join(sorted(cells))})")
    w = cells[workload]
    return compose(workload, w["config"], w["traffic"], int(w["chips"]), root)


def compose(name: str, config: str, traffic: str, chips: int = 1,
            root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``config`` under ``traffic`` from their files,
    with the metrics of BENCHMARK.json that apply to it; also a pairing
    that BENCHMARK.json does not list (the tests' output mix)."""
    bench = load_benchmark(root)
    entry = {c["name"]: c for c in bench["configs"]}[config]
    return Cell(
        name=name, config_name=config, traffic_name=traffic, chips=chips,
        config=_load_json(root / entry["file"]),
        traffic=_load_json(BENCH_DIR / "traffic" / f"{traffic}.json"),
        limits=_load_json(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def load_file_module(prefix: str, path: Path):
    """The module of the Python file ``path``, loaded by its path and named
    ``prefix`` and its stem (a file of the benchmark is named by a name of
    it, which may hold ``-`` and ``.``)."""
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``benchmarks/metrics/<name>.py``."""
    return load_file_module("bench_metric_", BENCH_DIR / "metrics" / f"{name}.py").read
