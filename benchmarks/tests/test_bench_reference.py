"""The plain reference against the program, at small sizes on the CPU: a
frame of each configuration is within the limits, the same frame rounded
to bfloat16 is not, and neither the harness nor the reference loads JAX or
the JAX package (nor, for the reference, the program).

    python -m pytest -q benchmarks/tests
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmarks.harness.cells import ROOT, resolve
from benchmarks.harness.check import compare
from benchmarks.harness.scenario import scenario_node
from benchmarks.harness.traffic import generate
from benchmarks.reference.newmark import build_system, judge

MESH = {"cantilever-255.sway": "synthetic://box/8,8,8",
        "tet-cantilever-66.sway": "synthetic://box/8,8,8,tet"}


def _frames(cell_name: str, frames: int = 3):
    """(system, [(before, after, t)]) of the program's first ``frames``
    frames of ``cell_name`` at 8^3, nodal rows in mesh order."""
    from civiwave_tpu_torch.config.loader import parse_config_node
    from civiwave_tpu_torch.runner import build_simulation

    cell = resolve(cell_name)
    traffic = generate(cell.traffic, 424242)
    node = scenario_node(cell.config, traffic, MESH[cell_name])
    sim = build_simulation(parse_config_node(node), device="cpu")

    def state():
        s = sim.stepper
        return [torch.as_tensor(x, dtype=torch.float64)
                for x in (s.displacement(), s.velocity(), s.acceleration())]

    out, before = [], state()
    for k in range(frames):
        sim.run(1)
        after = state()
        out.append((before, after, k * traffic.dt))
        before = after
    return build_system(node, traffic.dt, traffic.curve, "cpu"), cell.limits, out


@pytest.mark.parametrize("cell", sorted(MESH))
def test_reference_agrees_with_a_program_frame(cell):
    system, limits, frames = _frames(cell)
    for before, after, t in frames:
        numbers = judge(system, before, after, t)
        ok, compared = compare(numbers, limits)
        assert ok, compared
        assert numbers["residual"] <= 2e-4 * 1.01
        assert numbers["u_update"] < 1e-6 and numbers["v_update"] < 1e-6


@pytest.mark.parametrize("cell", sorted(MESH))
def test_frame_rounded_to_bf16_fails(cell):
    system, limits, frames = _frames(cell, frames=2)
    before, after, t = frames[-1]
    rounded = [x.to(torch.bfloat16).to(torch.float64) for x in after]
    ok, compared = compare(judge(system, before, rounded, t), limits)
    assert not ok
    assert compared["residual"]["value"] > 3 * limits["residual"]


def _loaded_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax():
    code = (
        "import json, sys, torch; torch.set_num_threads(2)\n"
        "from benchmarks.tests.support import run_small\n"
        "import benchmarks.run, benchmarks.control\n"
        "assert run_small('tet-cantilever-66.probes', 5, trace=True)['correct']\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = set(_loaded_after(code))
    assert "civiwave_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "civiwave_tpu"}


def test_reference_loads_neither_jax_nor_the_program():
    code = (
        "import json, sys, pkgutil, importlib\n"
        "import benchmarks.reference as r\n"
        "for m in pkgutil.iter_modules(r.__path__):\n"
        "    importlib.import_module('benchmarks.reference.' + m.name)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = set(_loaded_after(code))
    assert not tops & {"jax", "jaxlib", "flax", "civiwave_tpu", "civiwave_tpu_torch"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from benchmarks import run

    monkeypatch.setitem(sys.modules, "civiwave_tpu_torch_like", object())
    assert "civiwave_tpu_torch_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax.numpy"]
