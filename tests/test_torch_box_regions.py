"""Box regions: a ``synthetic://box`` scenario's named boxes of cells, bound
to materials by ``assignments``, on both of the port's routes.

* (a) the loader takes ``box_regions`` and refuses each malformed one with
  its breadcrumbs; the build refuses a region that holds no cell;
* (b) the structured model's per-cell lam, mu and mass, and the general
  path's element groups, agree with the benchmark reference's own layout
  (``benchmarks/reference/materials/hetero-cantilever-255.py``);
* (c) per-cell rho: the node mass is the f64 sum over the node's cells
  cast once, such a grid's ``m8`` is NaN and the plain operator and the
  per-node block-Jacobi read ``mass_grid``; one bound material builds
  today's homogeneous model bit for bit, with or without regions;
* (d) seeded random layouts and materials stepped through
  ``build_simulation`` -> ``Simulation.run`` on the structured route and
  on the general hex path, each frame judged by the benchmark reference
  within ``hetero-cantilever-255.sway``'s limits;
* (e) the same frame judged against the layout with the two regions'
  materials swapped is not correct;
* (f) the ``materials`` set-up phase and the cells of each material on
  the model, the simulation and ``--telemetry-json``.

CPU, boxes of a few dozen cells; the benchmark's reference is plain
PyTorch in float64.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from benchmarks.harness.cells import resolve
from benchmarks.harness.check import compare
from benchmarks.harness.scenario import scenario_node
from benchmarks.harness.traffic import generate
from benchmarks.reference import materials as ref_materials
from benchmarks.reference.mesh import parse_box
from benchmarks.reference.newmark import build_system, judge
from civiwave_tpu_torch import runner
from civiwave_tpu_torch.config.loader import parse_config_node
from civiwave_tpu_torch.config.schema import BoxRegion
from civiwave_tpu_torch.mesh import preprocess
from civiwave_tpu_torch.mesh.structured import CORNERS, build_structured_model
from civiwave_tpu_torch.mesh.structured_config import try_build_structured
from civiwave_tpu_torch.ops import structured as tops
from civiwave_tpu_torch.physics import materials
from civiwave_tpu_torch.utils import profiling
from civiwave_tpu_torch.utils.errors import ConfigError, PreprocessError

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "hetero-cantilever-255.sway"
CONFIG = "hetero-cantilever-255"
LAYOUT = ref_materials.layout(CONFIG)


def _node(cells="6,3,3", seed=424242):
    """(scenario node, traffic) of the cell at ``cells`` cells."""
    cell = resolve(CELL)
    traffic = generate(cell.traffic, seed)
    path = cell.config["scenario"]["mesh"]["path"]
    small = "synthetic://box/" + ",".join([cells, *path.split("/")[-1].split(",")[3:]])
    return scenario_node(cell.config, traffic, small), traffic


def _general(monkeypatch):
    """Send every scenario to the general gather path."""
    monkeypatch.setattr(runner, "try_build_structured", lambda *a, **k: None)


# --- (a) the loader and the build's refusals ----------------------------------


def test_a_loader_takes_box_regions():
    node, _ = _node()
    cfg = parse_config_node(node)
    assert cfg.box_regions == (
        BoxRegion("ROCK_LOWER", (0.0, 0.0, 0.0), (0.5, 1.0, 1.0)),
        BoxRegion("SOIL_UPPER", (0.5, 0.0, 0.0), (1.0, 1.0, 1.0)))
    del node["box_regions"]
    assert parse_config_node(node).box_regions == ()


_REGION = {"group": "R", "lo": [0.0, 0.0, 0.0], "hi": [0.5, 1.0, 1.0]}
# name -> (box_regions node or a change to the scenario, message, breadcrumbs)
_REFUSED = {
    "not_a_box": ("mesh", "box_regions requires a synthetic://box mesh",
                  ["box_regions"]),
    "not_a_sequence": ({"group": "R"}, "box_regions must be a sequence when present",
                       ["box_regions"]),
    "entry_not_a_map": (["R"], "box region must be a map", ["box_regions", "[0]"]),
    "missing_hi": ([{"group": "R", "lo": [0, 0, 0]}],
                   "box region missing required key 'hi'", ["box_regions", "[0]"]),
    "lo_below_0": ([{**_REGION, "lo": [0.0, -0.1, 0.0]}],
                   "box region fractions must be in [0, 1]",
                   ["box_regions", "[0]", "lo", "[1]"]),
    "hi_above_1": ([_REGION, {**_REGION, "group": "S", "hi": [1.0, 1.0, 1.5]}],
                   "box region fractions must be in [0, 1]",
                   ["box_regions", "[1]", "hi", "[2]"]),
    "lo_not_below_hi": ([{**_REGION, "lo": [0.5, 0.0, 0.0]}],
                        "box region needs lo < hi on every axis",
                        ["box_regions", "[0]", "hi", "[0]"]),
    "lo_vector_of_two": ([{**_REGION, "lo": [0.0, 0.0]}],
                         "expected sequence[3] for vector", ["box_regions", "[0]", "lo"]),
    "empty_name": ([{**_REGION, "group": ""}], "box region group name must be non-empty",
                   ["box_regions", "[0]", "group"]),
    "duplicate_name": ([_REGION, _REGION], "box region group names must be unique",
                       ["box_regions", "[1]", "group"]),
    **{f"own_group_{g}": ([{**_REGION, "group": g}],
                          "box region group name is one of the box's own groups",
                          ["box_regions", "[0]", "group"])
       for g in ("SOLID", "FIXED", "LOAD_FACE", "SIDE_Z1")},
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_a_loader_refuses(case):
    regions, message, context = _REFUSED[case]
    node, _ = _node()
    if regions == "mesh":
        node["mesh"]["path"] = "column.msh"
    else:
        node["box_regions"] = regions
    with pytest.raises(ConfigError) as err:
        parse_config_node(node)
    assert err.value.message == message
    assert err.value.context == context


@pytest.mark.parametrize("route", ["structured", "general"])
def test_a_a_region_that_holds_no_cell_is_refused(route, monkeypatch):
    """At 6 cells along x the cell centres lie at (i + 0.5) / 6: [0.5, 0.55)
    holds none; a region behind an earlier one that covers it holds none
    either."""
    if route == "general":
        _general(monkeypatch)
    node, _ = _node()
    thin = {"group": "THIN", "lo": [0.5, 0.0, 0.0], "hi": [0.55, 1.0, 1.0]}
    rock = node["box_regions"][0]
    for regions, index in (([*node["box_regions"], thin], 2),
                           ([rock, {**thin, "lo": [0.1, 0, 0], "hi": [0.45, 1, 1]}], 1)):
        node["box_regions"] = regions
        node["assignments"] = [{"group": r["group"], "material": "soil"}
                               for r in regions] + [{"group": "SOLID", "material": "rock"}]
        with pytest.raises(ConfigError) as err:
            runner.build_simulation(parse_config_node(node), device="cpu")
        assert err.value.message == (
            f"box region '{regions[index]['group']}' holds no cell of the 6x3x3 box")
        assert err.value.context == ["box_regions", f"[{index}]"]


def test_a_binding_errors_on_the_structured_route():
    node, _ = _node()
    node["assignments"][1]["group"] = "SOIL"  # no such group: SOIL_UPPER unbound
    with pytest.raises(PreprocessError, match="missing physical group 'SOIL'"):
        try_build_structured(parse_config_node(node), device="cpu")
    node["assignments"].pop(1)
    with pytest.raises(PreprocessError, match="'SOIL_UPPER' holds 27 cells and no"):
        try_build_structured(parse_config_node(node), device="cpu")


# --- (b) both routes against the reference's layout ----------------------------


def _node_mass64(rho, spacing):
    """The f64 node mass of per-cell densities, by a loop over the cells."""
    nx, ny, nz = rho.shape
    out = np.zeros((nx + 1, ny + 1, nz + 1))
    share = rho * (spacing ** 3 / 8.0)
    for a, b, c in CORNERS:
        out[a:a + nx, b:b + ny, c:c + nz] += share
    return out


@pytest.mark.parametrize("cells", ["6,3,3", "7,4,5"])
def test_b_both_routes_agree_with_the_references_layout(cells, monkeypatch):
    node, _ = _node(cells)
    box = parse_box(node["mesh"]["path"])
    lam, mu, rho = (f.reshape(box.nx, box.ny, box.nz)
                    for f in LAYOUT(box, node, "cpu"))
    cfg = parse_config_node(node)
    model, _ = try_build_structured(cfg, device="cpu")
    assert not model.homogeneous and math.isnan(model.m8)
    assert torch.equal(model.lam_cells, lam.float())
    assert torch.equal(model.mu_cells, mu.float())
    mass = _node_mass64(rho.numpy(), box.spacing).astype(np.float32)
    assert np.array_equal(model.mass_grid.numpy(), mass)
    rock = int((rho == 2700.0).sum())
    assert rock == box.ny * box.nz * 3  # centres below 0.5: i = 0, 1, 2
    assert dict(model.material_cells) == {"rock": rock, "soil": box.cell_count - rock}

    _general(monkeypatch)
    for element, per_cell in (("", 1), (",tet", 6)):
        node["mesh"]["path"] = f"synthetic://box/{cells}{element}"
        cfg = parse_config_node(node)
        mesh = runner._load_mesh(cfg, "")
        index = preprocess.run(mesh, cfg).element_material_index
        props = [materials.make_properties(m) for m in cfg.materials]
        got = np.array([[p.lame.lam, p.lame.mu, m.density]
                        for p, m in zip(props, cfg.materials)])[index]
        want = torch.stack([lam, mu, rho], dim=-1).reshape(-1, 3).numpy()
        assert np.array_equal(got, np.repeat(want, per_cell, axis=0))


# --- (c) per-cell rho, m8, one material bit for bit ------------------------------


def _props(E=2e11, nu=0.3, rho=7800.0):
    from civiwave_tpu_torch.config.schema import Material

    return materials.make_properties(Material("m", E, nu, rho))


@pytest.mark.parametrize("case", ["unit", "spacing_pad_x"])
def test_c_per_cell_rho_mass_is_the_f64_sum_cast_once(case):
    dims, spacing, kw = (((5, 4, 3), 1.0, {}) if case == "unit"
                         else ((4, 3, 3), 0.37, dict(pad_x_multiple=4)))
    rng = np.random.default_rng(7)
    rho = rng.uniform(1500.0, 8000.0, dims)
    gravity = (0.5, -9.81, 2.0)
    model, force = build_structured_model(
        *dims, _props(), 7800.0, spacing=(spacing,) * 3, gravity=gravity,
        device="cpu", rho_grid=rho, **kw)
    mass64 = _node_mass64(rho, spacing)
    x = dims[0] + 1
    assert np.array_equal(model.mass_grid[:x].numpy(), mass64.astype(np.float32))
    assert not model.mass_grid[x:].any()  # dead pad planes are massless
    weight = force.numpy()[:, :x]
    for c in range(3):
        assert np.array_equal(weight[c], (mass64 * gravity[c]).astype(np.float32))
    # densities that differ make a heterogeneous grid even where lam and mu
    # do not, with m8 NaN: the kernels that synthesize the mass from it decline
    assert not model.homogeneous and model.lam0 == model.mu0 == 0.0
    assert math.isnan(model.m8)


def test_c_reads_of_the_mass_take_mass_grid():
    """On a per-cell-rho grid (m8 NaN) the plain operator (G3's plain form)
    and the per-node block-Jacobi are finite and the operator is the
    reference's K_eff to 1e-6 of its largest entry."""
    node, traffic = _node("5,3,4")
    model, _ = try_build_structured(parse_config_node(node), device="cpu")
    assert math.isnan(model.m8)
    system = build_system(node, traffic.dt, traffic.curve, "cpu", config=CONFIG)
    ss, mf = system.scalars()
    x = torch.randn(system.box.node_count, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5))
    x = x.masked_fill(system.fixed, 0.0)
    grid = x.reshape(*model.grid_shape, 3).permute(3, 0, 1, 2).contiguous()
    got = model.to_nodal(tops.apply_keff_structured_plain(model, grid, ss, mf))
    want = system.keff(x)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    inverse = model.build_preconditioner(np.float32(ss), np.float32(mf))
    assert bool(torch.isfinite(inverse).all())
    z = model.apply_preconditioner(inverse, grid.float())
    assert bool(torch.isfinite(z).all())


def _fields_equal(a, b) -> bool:
    for f in dataclasses.fields(a):
        if f.name == "material_cells":
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if torch.is_tensor(x):
            if not (x.dtype == y.dtype and torch.equal(x, y)):
                return False
        elif isinstance(x, np.ndarray):
            if not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


@pytest.mark.parametrize("regions", [False, True])
def test_c_one_material_builds_todays_model_bit_for_bit(regions):
    """The one-material box of today's structured route, and the same box
    with regions that all bind one material (a second, unused, listed)."""
    node, _ = _node("6,3,3")
    rock = node["materials"][0]
    if regions:
        node["assignments"] = [{"group": r["group"], "material": "rock"}
                               for r in node["box_regions"]]
    else:
        del node["box_regions"]
        node["materials"] = [rock]
        node["assignments"] = [{"group": "SOLID", "material": "rock"}]
    cfg = parse_config_node(node)
    model, schedule = try_build_structured(cfg, device="cpu")
    h = (parse_box(node["mesh"]["path"]).spacing,) * 3
    today, force = build_structured_model(
        6, 3, 3, materials.make_properties(cfg.materials[0]), rock["rho"],
        spacing=h, fixes=[("x0", (True, True, True), (None, None, None))],
        device="cpu")
    assert model.homogeneous and _fields_equal(model, today)
    assert torch.equal(schedule.base, force)
    assert dict(model.material_cells) == {"rock": 54}
    # a rho grid of one value is that density
    same, _ = build_structured_model(
        6, 3, 3, materials.make_properties(cfg.materials[0]), 1.0, spacing=h,
        fixes=[("x0", (True, True, True), (None, None, None))], device="cpu",
        rho_grid=np.full((6, 3, 3), rock["rho"]))
    assert _fields_equal(same, today)


# --- (d) seeded random layouts: both routes judged by the reference ----------------


def _random_scenario(seed):
    """The cell's scenario at 6x3x3 with 2-3 materials (E in [1e8, 1e11],
    nu in [0.2, 0.4], rho in [1500, 8000]) and 1-3 regions of whole cells
    drawn from ``seed``, SOLID and each region bound to a material, at
    least two of them in use."""
    from civiwave_tpu_torch.utils.synthetic import box_cell_groups

    rng = np.random.default_rng(seed)
    node, traffic = _node("6,3,3", seed)
    dims = (6, 3, 3)
    while True:
        mats = [{"name": f"m{i}", "E": float(10 ** rng.uniform(8, 11)),
                 "nu": float(rng.uniform(0.2, 0.4)),
                 "rho": float(rng.uniform(1500, 8000))}
                for i in range(int(rng.integers(2, 4)))]
        regions = []
        for r in range(int(rng.integers(1, 4))):
            spans = [np.sort(rng.choice(n + 1, 2, replace=False)) for n in dims]
            regions.append({"group": f"R{r}",
                            "lo": [float(s[0] / n) for s, n in zip(spans, dims)],
                            "hi": [float(s[1] / n) for s, n in zip(spans, dims)]})
        groups = ["SOLID"] + [r["group"] for r in regions]
        bound = [int(rng.integers(len(mats))) for _ in groups]
        cfg_regions = [BoxRegion(r["group"], tuple(r["lo"]), tuple(r["hi"]))
                       for r in regions]
        try:
            cells = box_cell_groups(cfg_regions, *dims).reshape(-1)
        except ConfigError:
            continue  # a region behind the others: draw again
        used = {bound[g] for g in cells.unique().tolist()}
        if len(used) >= 2:
            break
    node["materials"] = mats
    node["box_regions"] = regions
    node["assignments"] = [{"group": g, "material": mats[m]["name"]}
                           for g, m in zip(groups, bound)]
    return node, traffic


def _frames(node, frames=3):
    """(route, [(before, after, t)]) of ``frames`` frames from rest, nodal
    rows in mesh order in float64."""
    sim = runner.build_simulation(parse_config_node(node), device="cpu")

    def state():
        s = sim.stepper
        return [torch.as_tensor(x, dtype=torch.float64)
                for x in (s.displacement(), s.velocity(), s.acceleration())]

    out, before = [], state()
    dt = float(node["time"]["dt"])
    for k in range(frames):
        (tel,) = sim.run(1)
        assert tel.pcg_converged
        after = state()
        out.append((before, after, k * dt))
        before = after
    return ("structured" if sim.structured else "general"), out


@pytest.mark.parametrize("seed", [3100000101, 3100000102, 3100000103])
def test_d_random_layouts_are_correct_on_both_routes(seed, monkeypatch):
    node, traffic = _random_scenario(seed)
    limits = resolve(CELL).limits
    system = build_system(node, traffic.dt, traffic.curve, "cpu", config=CONFIG)
    route, structured = _frames(node)
    assert route == "structured"
    _general(monkeypatch)
    route, general = _frames(node)
    assert route == "general"
    for frames in (structured, general):
        for before, after, t in frames:
            ok, compared = compare(judge(system, before, after, t), limits)
            assert ok, compared
    # the two routes solve the same system to the same tolerance
    u_s, u_g = structured[-1][1][0], general[-1][1][0]
    assert float((u_s - u_g).abs().max()) <= 2e-3 * float(u_g.abs().max())


# --- (e) the swapped layout -----------------------------------------------------------


def test_e_a_frame_judged_against_the_swapped_layout_is_not_correct():
    node, traffic = _node("6,3,3")
    limits = resolve(CELL).limits
    _, frames = _frames(node, frames=4)
    before, after, t = frames[-1]
    system = build_system(node, traffic.dt, traffic.curve, "cpu", config=CONFIG)
    ok, compared = compare(judge(system, before, after, t), limits)
    assert ok, compared
    swapped = copy.deepcopy(node)
    for a in swapped["assignments"]:
        a["material"] = {"rock": "soil", "soil": "rock"}[a["material"]]
    system = build_system(swapped, traffic.dt, traffic.curve, "cpu", config=CONFIG)
    ok, compared = compare(judge(system, before, after, t), limits)
    assert not ok
    assert compared["residual"]["value"] > 100 * limits["residual"], compared


# --- (f) the set-up phase and the cells of each material -----------------------------


def test_f_materials_phase_and_cells_per_material(tmp_path, monkeypatch):
    node, _ = _node("6,3,3")
    sim = runner.build_simulation(parse_config_node(node), device="cpu")
    assert set(profiling.phases) == {"materials"} and profiling.phases["materials"] > 0
    assert sim.material_cells == {"rock": 27, "soil": 27}
    (tel,) = sim.run(1)
    assert tel.pcg_converged
    # no regions: no phase, the one material's cells
    del node["box_regions"]
    node["materials"] = node["materials"][:1]
    node["assignments"] = [{"group": "SOLID", "material": "rock"}]
    sim = runner.build_simulation(parse_config_node(node), device="cpu")
    assert "materials" not in profiling.phases
    assert sim.material_cells == {"rock": 54}
    # the CLI's --telemetry-json, the example at 8x2x2 cells of 1 m, on
    # both routes (the general path counts its elements: six tets a cell)
    with open(os.path.join(REPO, "examples", "seismic_column_box.yaml"),
              encoding="utf-8") as f:
        text = f.read()
    assert "synthetic://box/32,8,8,0.25" in text
    for mesh, counts in (("8,2,2", {"rock": 16, "soil": 16}),
                         ("8,2,2,tet", {"rock": 96, "soil": 96})):
        path = tmp_path / "column.yaml"
        path.write_text(text.replace("32,8,8,0.25", mesh))
        out = tmp_path / "telemetry.json"
        assert runner.main([str(path), "--frames", "2", "--quiet", "--device", "cpu",
                            "--telemetry-json", str(out)]) == 0
        frames = json.loads(out.read_text())
        assert frames[0]["material_cells"] == counts
        assert "material_cells" not in frames[1]
        assert all(f["pcg_converged"] for f in frames)
