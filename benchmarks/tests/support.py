"""Small runs of the benchmark's cells on the CPU, for its tests."""

from __future__ import annotations

import copy
import io
import time

import torch

from benchmarks.harness.cells import compose, load_benchmark, resolve
from benchmarks.run import run_cell

BOX = "synthetic://box/"
# the cells of BENCHMARK.json, and a pairing it does not list: the output mix
CELLS = [w["name"] for w in load_benchmark()["workloads"]]
OUTPUT_CELL = "tet-cantilever-66.probes"


def small_mesh(config: dict, cells: str = "6,3,3") -> str:
    """A configuration's own mesh at a size a CPU test holds: its synthetic
    box with ``cells`` cells along x, y and z and its other options (the
    element, the spacing) kept, so a configuration added later is covered
    as it is."""
    path = config["scenario"]["mesh"]["path"]
    if not path.startswith(BOX):
        raise ValueError(f"the reference takes synthetic boxes, not {path}")
    return BOX + ",".join([cells, *path[len(BOX):].split(",")[3:]])


def small_cell(name: str, warmup_frames: int = 3):
    """A cell of BENCHMARK.json, or a ``<config>.<traffic>`` pairing it does
    not list (the output mix, ``OUTPUT_CELL``), at a few
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
                    time.monotonic(), mesh_path=small_mesh(cell.config),
                    log=io.StringIO(), control_dtype=control_dtype)
