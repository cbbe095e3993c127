"""The plain reference against the program, at small sizes on the CPU: a
frame of each configuration is within the limits, the same frame rounded
to bfloat16 is not, and neither the harness nor the reference loads JAX or
the JAX package (nor, for the reference, the program).  Materials that
vary by cell: a field of one value is the float bit for bit, two layers
agree with the program's heterogeneous operator, a configuration's layout
file is found by its name, and a frame solved with the layers swapped is
not correct.

    python -m pytest -q benchmarks/tests
"""

from __future__ import annotations

import copy
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks.harness.cells import ROOT, resolve
from benchmarks.harness.check import compare
from benchmarks.harness.scenario import scenario_node
from benchmarks.harness.traffic import generate
from benchmarks.reference import elastic, materials, solve
from benchmarks.reference.mesh import parse_box
from benchmarks.reference.newmark import build_system, judge
from benchmarks.tests.support import CELLS, run_small, small_mesh
from benchmarks.tests.two_layers import cell_fields as two_layers

LAYERS = Path(__file__).with_name("two_layers.py")
STEEL = {"name": "steel", "E": 2e11, "nu": 0.3, "rho": 7800.0}
# a second material of the same density: the layers differ in lam and mu
CONCRETE = {"name": "concrete", "E": 3e10, "nu": 0.2, "rho": 7800.0}
LAYERED_BOX = "synthetic://box/6,4,4"



def _frames(cell_name: str, frames: int = 3):
    """(system, [(before, after, t)]) of the program's first ``frames``
    frames of ``cell_name`` at 8^3 cells of its configuration's mesh, nodal
    rows in mesh order, judged with the configuration's own materials."""
    from civiwave_tpu_torch.config.loader import parse_config_node
    from civiwave_tpu_torch.runner import build_simulation

    cell = resolve(cell_name)
    traffic = generate(cell.traffic, 424242)
    node = scenario_node(cell.config, traffic, small_mesh(cell.config, "8,8,8"))
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
    system = build_system(node, traffic.dt, traffic.curve, "cpu", config=cell.config_name)
    return system, cell.limits, out


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_a_program_frame(cell):
    system, limits, frames = _frames(cell)
    for before, after, t in frames:
        numbers = judge(system, before, after, t)
        ok, compared = compare(numbers, limits)
        assert ok, compared
        assert numbers["residual"] <= 2e-4 * 1.01
        assert numbers["u_update"] < 1e-6 and numbers["v_update"] < 1e-6


@pytest.mark.parametrize("cell", CELLS)
def test_frame_rounded_to_bf16_fails(cell):
    system, limits, frames = _frames(cell, frames=2)
    before, after, t = frames[-1]
    rounded = [x.to(torch.bfloat16).to(torch.float64) for x in after]
    ok, compared = compare(judge(system, before, rounded, t), limits)
    assert not ok
    assert compared["residual"]["value"] > 3 * limits["residual"]


@pytest.mark.parametrize("mesh", ["synthetic://box/5,4,3", "synthetic://box/5,4,3,tet"])
def test_a_field_of_one_value_is_the_float_bit_for_bit(mesh, monkeypatch):
    monkeypatch.setattr(elastic, "CELLS_PER_BLOCK", 7)  # blocks, the last one short
    box = parse_box(mesh)
    lam, mu = elastic.lame(2e11, 0.3)
    rho = 7800.0
    lam_c, mu_c, rho_c = (torch.full((box.cell_count,), v, dtype=torch.float64)
                          for v in (lam, mu, rho))
    x = torch.randn(box.node_count, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    assert torch.equal(elastic.stiffness_apply(box, lam, mu, x),
                       elastic.stiffness_apply(box, lam_c, mu_c, x))
    f64 = torch.float64
    assert torch.equal(elastic.stiffness_diagonal(box, lam, mu, "cpu", f64),
                       elastic.stiffness_diagonal(box, lam_c, mu_c, "cpu", f64))
    assert torch.equal(elastic.lumped_mass(box, rho, "cpu"),
                       elastic.lumped_mass(box, rho_c, "cpu"))
    rows = list(zip(elastic.strain_rows(box, lam, mu, x),
                    elastic.strain_rows(box, lam_c, mu_c, x)))
    assert len(rows) == math.ceil(box.cell_count / 7)
    for one, per_cell in rows:
        assert all(torch.equal(a, b) for a, b in zip(one, per_cell))


def _heterogeneous_operator(box, lam, mu):
    """The program's own K x on a heterogeneous grid (per-cell lam and mu,
    G3's plain version), stiffness scale 1 and mass factor 0, on nodal rows
    in float64: identity rows where the x = 0 plane is fixed."""
    from civiwave_tpu_torch.config.schema import Material
    from civiwave_tpu_torch.mesh.structured import build_structured_model
    from civiwave_tpu_torch.ops.structured import apply_keff_structured_plain
    from civiwave_tpu_torch.physics.materials import make_properties

    cells = [f.reshape(box.nx, box.ny, box.nz).numpy() for f in (lam, mu)]
    model, _ = build_structured_model(
        box.nx, box.ny, box.nz, make_properties(Material("steel", 2e11, 0.3, 7800.0)),
        7800.0, device="cpu", lam_grid=cells[0], mu_grid=cells[1])
    assert not model.homogeneous
    shape = (box.nx + 1, box.ny + 1, box.nz + 1, 3)

    def apply(rows):
        grid = rows.reshape(shape).permute(3, 0, 1, 2).contiguous()
        return model.to_nodal(apply_keff_structured_plain(model, grid, 1.0, 0.0))
    return apply


def _probed_diagonal(box, apply):
    """The diagonal of ``apply`` from 24 products: a unit entry in one
    component at every node of one of the 8 (i, j, k) parity classes, whose
    nodes share no element."""
    i, j, k = box.node_index("cpu")
    parity = (i % 2) * 4 + (j % 2) * 2 + k % 2
    out = torch.zeros((box.node_count, 3), dtype=torch.float64)
    for p in range(8):
        nodes = parity == p
        for c in range(3):
            e = torch.zeros((box.node_count, 3), dtype=torch.float64)
            e[nodes, c] = 1.0
            out[nodes, c] = apply(e)[nodes, c]
    return out


def test_b_two_layers_agree_with_the_programs_heterogeneous_operator():
    """The program keeps lam and mu per cell in float32 and rounds its
    gradient weights and Gauss volumes to float32, then works in float64;
    that puts its K x and diagonal within 9e-8 of the largest entry of the
    reference's.  The limit 1e-6 leaves ten times that; the two layers'
    materials swapped read 0.86."""
    box = parse_box(LAYERED_BOX)
    lam, mu, _ = two_layers(box, {"materials": [STEEL, CONCRETE]}, "cpu")
    lam_s, mu_s, _ = two_layers(box, {"materials": [CONCRETE, STEEL]}, "cpu")
    free = ~box.fixed_mask("cpu")
    apply = _heterogeneous_operator(box, lam, mu)
    x = torch.randn(box.node_count, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(11))
    want_kx = apply(x)[free]
    want_diag = _probed_diagonal(box, apply)[free]

    def gaps(lam, mu):
        kx = elastic.stiffness_apply(box, lam, mu, x.masked_fill(~free, 0.0))[free]
        diag = elastic.stiffness_diagonal(box, lam, mu, "cpu", torch.float64)[free]
        return ((kx - want_kx).abs().max() / want_kx.abs().max(),
                (diag - want_diag).abs().max() / want_diag.abs().max())

    assert all(gap <= 1e-6 for gap in gaps(lam, mu)), gaps(lam, mu)
    assert all(gap > 1e-4 for gap in gaps(lam_s, mu_s)), gaps(lam_s, mu_s)


def test_c_lumped_mass_with_rho_per_cell():
    box = parse_box("synthetic://box/2,1,1")  # two unit cubes along x, 12 nodes
    rho = torch.tensor([1000.0, 3000.0], dtype=torch.float64)
    i, _, _ = box.node_index("cpu")
    # each hex gives rho V / 8 to each of its 8 corners, V = 1 (summed over
    # Gauss points from the Jacobian's determinant, to float64 rounding)
    want = torch.tensor([1000.0 / 8, 1000.0 / 8 + 3000.0 / 8, 3000.0 / 8],
                        dtype=torch.float64)[i]
    torch.testing.assert_close(elastic.lumped_mass(box, rho, "cpu"), want,
                               rtol=1e-14, atol=0.0)


@pytest.fixture
def layouts(tmp_path, monkeypatch):
    """A directory of layout files in place of ``benchmarks/reference/materials``."""
    monkeypatch.setattr(materials, "DIR", tmp_path)
    return tmp_path


def _scenario(mats):
    cell = resolve("cantilever-255.sway")
    traffic = generate(cell.traffic, 424242)
    node = scenario_node(cell.config, traffic, LAYERED_BOX)
    node["materials"] = copy.deepcopy(mats)
    return node, traffic


def test_d_a_configurations_layout_is_found_by_its_name(layouts):
    shutil.copy(LAYERS, layouts / "test-layers.py")
    node, traffic = _scenario([STEEL, CONCRETE])
    system = build_system(node, traffic.dt, traffic.curve, "cpu", config="test-layers")
    box = system.box
    for got, want in zip((system.lam, system.mu, system.rho),
                         two_layers(box, node, "cpu")):
        assert torch.equal(got, want)
    assert torch.equal(system.mass, elastic.lumped_mass(box, system.rho, "cpu"))
    # one material and no file: the floats, as before layouts
    single, _ = _scenario([STEEL])
    system = build_system(single, traffic.dt, traffic.curve, "cpu",
                          config="test-layers-1")
    assert (system.lam, system.mu, system.rho) == (*elastic.lame(2e11, 0.3), 7800.0)
    # two materials and no file: refused, naming the file it needs
    with pytest.raises(ValueError, match="test-layers-2.py"):
        build_system(node, traffic.dt, traffic.curve, "cpu", config="test-layers-2")


def test_d_a_run_judges_with_its_configurations_layout(layouts):
    (layouts / "cantilever-255.py").write_text(
        "def cell_fields(box, scenario, device):\n"
        "    raise LookupError('the layout of cantilever-255')\n")
    with pytest.raises(LookupError, match="the layout of cantilever-255"):
        run_small("cantilever-255.sway", 8)


def test_e_a_frame_with_the_layers_swapped_is_not_correct(layouts):
    """The frame of largest load from rest, solved by the reference in
    float32 to the configuration's tolerance with the two layers' materials
    swapped, judged against the right layout under cantilever-255.sway's
    limits; the same solve with the right layout is correct."""
    shutil.copy(LAYERS, layouts / "test-layers.py")
    limits = resolve("cantilever-255.sway").limits
    node, traffic = _scenario([STEEL, CONCRETE])
    swapped_node, _ = _scenario([CONCRETE, STEEL])
    system, swapped = (build_system(n, traffic.dt, traffic.curve, "cpu",
                                    config="test-layers")
                       for n in (node, swapped_node))
    frame = int(np.argmax(np.abs(system.curve_v[:64])))
    t = frame * traffic.dt
    rest = [torch.zeros((system.box.node_count, 3), dtype=torch.float64)] * 3
    solver = node["solver"]

    def solved(s):
        state, _ = solve.frame(s, rest, t, torch.float32, float(solver["tol_runtime"]),
                               int(solver["max_iters"]))
        return [x.double() for x in state]

    ok, compared = compare(judge(system, rest, solved(system), t), limits)
    assert ok, compared
    ok, compared = compare(judge(system, rest, solved(swapped), t), limits)
    assert not ok
    # the 2-norm residual catches it: 1.33, 6.3e3 times its limit
    # (residual_max 0.96, 32 times its own)
    assert compared["residual"]["value"] > 100 * limits["residual"], compared


def _loaded_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax():
    code = (
        "import json, sys, torch; torch.set_num_threads(2)\n"
        "from benchmarks.tests.support import CELLS, run_small, small_mesh\n"
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
        "from benchmarks.harness.cells import load_file_module\n"
        "from benchmarks.reference import materials\n"
        "for m in pkgutil.iter_modules(r.__path__):\n"
        "    importlib.import_module('benchmarks.reference.' + m.name)\n"
        "layouts = [f for f in materials.DIR.glob('*.py') if f.name != '__init__.py']\n"
        f"for f in layouts + [materials.Path({str(LAYERS)!r})]:\n"
        "    assert callable(load_file_module('layout_', f).cell_fields)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = set(_loaded_after(code))
    assert not tops & {"jax", "jaxlib", "flax", "civiwave_tpu", "civiwave_tpu_torch"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from benchmarks import run

    monkeypatch.setitem(sys.modules, "civiwave_tpu_torch_like", object())
    assert "civiwave_tpu_torch_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax.numpy"]
