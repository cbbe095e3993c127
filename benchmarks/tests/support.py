"""Small runs of the benchmark's cells on the CPU, for its tests."""

from __future__ import annotations

import copy
import io
import time

import torch

from benchmarks.harness.cells import compose, load_benchmark, resolve
from benchmarks.run import run_cell

# the cells' configurations at sizes a CPU test holds
SMALL_MESH = {
    "cantilever-255": "synthetic://box/6,3,3",
    "tet-cantilever-66": "synthetic://box/6,3,3,tet",
}


def small_cell(name: str, warmup_frames: int = 3):
    """A cell of BENCHMARK.json, or a ``<config>.<traffic>`` pairing it does
    not list (the output mix, ``tet-cantilever-66.probes``), at a few
    warm-up frames."""
    listed = {w["name"] for w in load_benchmark()["workloads"]}
    cell = resolve(name) if name in listed else compose(name, *name.rsplit(".", 1))
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["warmup_frames"] = warmup_frames
    return cell


def run_small(name: str, seed: int, trace: bool = False, seconds: float = 0.3,
              control_dtype=None) -> dict:
    """One run of ``name`` at its small size on the CPU (no look for a
    card); the stderr lines go to a string."""
    cell = small_cell(name)
    return run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                    time.monotonic(), mesh_path=SMALL_MESH[cell.config_name],
                    log=io.StringIO(), control_dtype=control_dtype)
