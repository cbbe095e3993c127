"""The general gather path end to end: the port's runner and stepper
against the JAX package's.

N-step trajectories of a small tet cantilever (a synthetic tet box through
both runners), a shuffled hex box (both packages' steppers over their own
packs) and ``examples/seismic_column_tet.yaml`` (tet Gmsh mesh, two
materials, curve-scaled traction, through both runners).  Tolerances (the
BASELINE stepping tolerances in ROADMAP): PCG iterations within +-1 per
frame, displacement at 2.5e-4 * max|ref| and acceleration at
3e-3 * max|ref|, compared in nodal order (the two packs may number nodes
differently).  The CLI runs the column.

The acceleration a = delta / (beta dt^2) amplifies the solver's rounding:
in the reference itself, the same shuffled box stepped with and without
its node renumbering differs by ~8e-3 of max|a| after 8 frames.  So the
shuffled box holds the full tolerances on the reference's own model carried
across through ``convert`` (the same numbering), and on the port's own pack
(RCM numbering) holds iterations and displacement.
"""

import json

import numpy as np
import pytest
import torch
import yaml

from civiwave_tpu.mesh import pack as jpack
from civiwave_tpu.mesh import preprocess as jpreprocess
from civiwave_tpu.physics import materials as jmaterials
from civiwave_tpu.runner import build_simulation as jbuild_simulation
from civiwave_tpu.solver.stepper import NewmarkStepper as JNewmarkStepper
from civiwave_tpu_torch.mesh import pack, preprocess
from civiwave_tpu_torch.mesh.pack import PackedModel
from civiwave_tpu_torch.physics import materials
from civiwave_tpu_torch.runner import build_simulation, main
from civiwave_tpu_torch.solver.stepper import NewmarkStepper
from civiwave_tpu_torch.utils.synthetic import cantilever_config
from torch_general_support import (
    A_TOL,
    COLUMN_YAML,
    U_TOL,
    configs,
    mesh_pair,
    to_port_packed,
)

torch.set_num_threads(2)


def _compare(tel, ref_tel, stepper, ref_stepper):
    iters = [t.pcg_iterations for t in tel]
    ref_iters = [t.pcg_iterations for t in ref_tel]
    assert all(abs(a - b) <= 1 for a, b in zip(iters, ref_iters)), (iters, ref_iters)
    assert len(iters) == len(ref_iters)
    assert all(t.pcg_converged for t in tel)
    assert [t.time_step for t in tel] == [t.time_step for t in ref_tel]
    for name, tol in (("displacement", U_TOL), ("acceleration", A_TOL)):
        ref = np.asarray(getattr(ref_stepper, name)())
        np.testing.assert_allclose(
            getattr(stepper, name)(), ref, rtol=0.0,
            atol=tol * np.abs(ref).max(), err_msg=name,
        )


def test_tet_cantilever_matches_the_reference_runner(tmp_path):
    node = dict(
        mesh={"path": "synthetic://box/6,3,3,tet"},
        time={"dt": 1.0e-3, "adaptive": True, "min_dt": 5.0e-4, "max_dt": 2.0e-3},
        solver={"type": "pcg", "preconditioner": "block_jacobi",
                "tol_runtime": 2.0e-4, "tol_pause": 1.0e-5, "max_iters": 200},
        loads={"gravity": [0.0, 0.0, -9.81],
               "tractions": [{"group": "LOAD_FACE", "value": [0.0, 0.0, -1.0e6],
                              "scale_curve": "ramp"}]},
        curves={"ramp": [[0.0, 0.0], [0.004, 1.0]]},
    )
    base = yaml.safe_load(open(COLUMN_YAML))  # any full document to extend
    doc = {**base, **node, "materials": [
        {"name": "steel", "E": 2.0e11, "nu": 0.3, "rho": 7800.0}],
        "assignments": [{"group": "SOLID", "material": "steel"}],
        "dirichlet": {"fixes": [{"group": "FIXED", "dof": ["x", "y", "z"]}]}}
    path = tmp_path / "tet_cantilever.yaml"
    path.write_text(yaml.safe_dump(doc))
    ref = jbuild_simulation(str(path))
    ref_tel = ref.run(8)
    sim = build_simulation(str(path), device="cpu")
    assert isinstance(sim.model, PackedModel) and sim.model.tet_count == 324
    tel = sim.run(8)
    _compare(tel, ref_tel, sim.stepper, ref.stepper)


def test_shuffled_hex_box_matches_the_reference_stepper():
    (pm, jm), (pc, jc) = mesh_pair("shuffled"), configs(
        solver={"type": "pcg", "preconditioner": "block_jacobi",
                "tol_runtime": 2.0e-4, "tol_pause": 1.0e-5, "max_iters": 120},
    )
    jmats = [jmaterials.make_properties(m) for m in jc.materials]
    jmodel, jstate, jforce = jpack.build_packed_model(
        jm, jpreprocess.run(jm, jc), jc, jmats
    )
    ref = JNewmarkStepper(jmodel, jstate, jforce,
                          jmaterials.compute_rayleigh(jc.damping), jc.solver, jc.time)
    ref_tel = [ref.step(ref.accumulated_time) for _ in range(8)]
    rayleigh = materials.compute_rayleigh(pc.damping)

    # the reference's model carried across: same numbering, full tolerances
    carried = to_port_packed(jmodel)
    ours = NewmarkStepper(carried, carried.zero_state(),
                          torch.as_tensor(np.array(jforce)), rayleigh,
                          pc.solver, pc.time)
    tel = [ours.step(ours.accumulated_time) for _ in range(8)]
    _compare(tel, ref_tel, ours, ref)

    # the port's own pack (RCM): iterations and displacement
    mats = [materials.make_properties(m) for m in pc.materials]
    model, state, force = pack.build_packed_model(
        pm, preprocess.run(pm, pc), pc, mats, device="cpu"
    )
    assert model.renumbered
    own = NewmarkStepper(model, state, force, rayleigh, pc.solver, pc.time)
    own_tel = [own.step(own.accumulated_time) for _ in range(8)]
    assert all(abs(a.pcg_iterations - b.pcg_iterations) <= 1
               for a, b in zip(own_tel, ref_tel))
    ref_u = np.asarray(ref.displacement())
    np.testing.assert_allclose(own.displacement(), ref_u, rtol=0.0,
                               atol=U_TOL * np.abs(ref_u).max())


@pytest.fixture(scope="module")
def column_reference():
    ref = jbuild_simulation(COLUMN_YAML)
    return ref.run(10), ref.stepper


def test_seismic_column_matches_the_reference_runner(column_reference):
    ref_tel, ref_stepper = column_reference
    sim = build_simulation(COLUMN_YAML, device="cpu")
    assert len(sim.config.materials) == 2 and sim.model.tet_count == 1536
    tel = sim.run(10)
    _compare(tel, ref_tel, sim.stepper, ref_stepper)


def test_cli_runs_the_column_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "telemetry.json"
    rc = main([COLUMN_YAML, "--frames", "2", "--quiet", "--device", "cpu",
               "--telemetry-json", str(out)])
    assert rc == 0
    frames = json.loads(out.read_text())
    assert len(frames) == 2 and all(f["pcg_converged"] for f in frames)
    captured = capsys.readouterr()
    assert "ran 2 frames" in captured.out
    assert "general gather path" in captured.err


def _point_load_gmsh(path):
    """A Gmsh 4.1 file of a 4x1x1 tet bar: two volume groups (SOFT for
    x < 2, STIFF beyond), the FIXED quads at x = 0 and a dim-0 TIP group on
    the far corner node, which carries the point load."""
    from civiwave_tpu_torch.utils.synthetic import box_mesh

    box = box_mesh(4, 1, 1)
    pos = box.node_positions
    tip = int(np.flatnonzero((pos == [4.0, 1.0, 1.0]).all(axis=1))[0])
    rest = [i for i in range(len(pos)) if i != tip]
    tets = box.elements[:, :4] + 1
    soft = pos[box.elements[:, :4]].mean(axis=1)[:, 0] < 2.0
    quads = box.surfaces[box.surface_physical_group == 1] + 1

    def block(dim, tag, etype, rows, first):
        lines = [f"{dim} {tag} {etype} {len(rows)}"]
        lines += [" ".join(map(str, [first + i, *r])) for i, r in enumerate(rows)]
        return lines

    lines = [
        "$MeshFormat", "4.1 0 8", "$EndMeshFormat",
        "$PhysicalNames", "4", '0 13 "TIP"', '2 10 "FIXED"', '3 11 "SOFT"',
        '3 12 "STIFF"', "$EndPhysicalNames",
        "$Entities", "1 0 1 2", "1 4 1 1 1 13", "1 0 0 0 0 1 1 1 10 0",
        "1 0 0 0 2 1 1 1 11 0", "2 2 0 0 4 1 1 1 12 0", "$EndEntities",
        "$Nodes", f"2 {len(pos)} 1 {len(pos)}", "0 1 0 1", str(tip + 1),
        " ".join(map(str, pos[tip])), f"3 1 0 {len(rest)}",
        *[str(i + 1) for i in rest], *[" ".join(map(str, pos[i])) for i in rest],
        "$EndNodes",
        "$Elements", f"3 {len(quads) + len(tets)} 1 {len(quads) + len(tets)}",
        *block(2, 1, 3, quads, 1),
        *block(3, 1, 4, tets[soft], 1 + len(quads)),
        *block(3, 2, 4, tets[~soft], 1 + len(quads) + int(soft.sum())),
        "$EndElements",
    ]
    path.write_text("\n".join(lines) + "\n")


def test_point_load_and_two_materials_match_the_reference(tmp_path):
    """A Gmsh file with two materials and a curve-scaled point load on a
    dim-0 node group: the general route through both runners."""
    _point_load_gmsh(tmp_path / "bar.msh")
    doc = {
        "mesh": {"path": "bar.msh"},
        "materials": [{"name": "soft", "E": 2.0e9, "nu": 0.3, "rho": 2000.0},
                      {"name": "stiff", "E": 2.0e11, "nu": 0.3, "rho": 7800.0}],
        "assignments": [{"group": "SOFT", "material": "soft"},
                        {"group": "STIFF", "material": "stiff"}],
        "damping": {"xi": 0.02, "w1": 10.0, "w2": 100.0},
        "time": {"dt": 1.0e-3, "adaptive": False},
        "solver": {"type": "pcg", "preconditioner": "block_jacobi",
                   "tol_runtime": 2.0e-4, "tol_pause": 1.0e-5, "max_iters": 200},
        "precision": {"vectors": "fp32", "reductions": "fp64"},
        "curves": {"ramp": [[0.0, 0.0], [0.004, 1.0]]},
        "loads": {"gravity": [0.0, 0.0, -9.81],
                  "points": [{"group": "TIP", "value": [0.0, 0.0, -1.0e5],
                              "scale_curve": "ramp"}]},
        "dirichlet": {"fixes": [{"group": "FIXED", "dof": ["x", "y", "z"]}]},
        "output": {"vtu_stride": 1, "probes": []},
    }
    path = tmp_path / "bar.yaml"
    path.write_text(yaml.safe_dump(doc))
    ref = jbuild_simulation(str(path))
    ref_tel = ref.run(6)
    sim = build_simulation(str(path), device="cpu")
    assert isinstance(sim.model, PackedModel)
    assert sorted(set(sim.model.mat_tet[: sim.model.tet_count].tolist())) == [0, 1]
    tel = sim.run(6)
    _compare(tel, ref_tel, sim.stepper, ref.stepper)
    # the point load reached the tip: it moved down
    tip = sim.mesh.node_groups[13][0]
    assert sim.stepper.displacement()[tip, 2] < 0.0


def test_general_route_takes_a_parsed_config():
    """A parsed Config (no YAML, no pyyaml) with a tet box routes onto the
    general path and steps."""
    cfg = cantilever_config(
        mesh={"path": "synthetic://box/4,2,2,tet"}, tol_runtime=2e-4,
        max_iters=200,
    )
    sim = build_simulation(cfg, device="cpu")
    assert isinstance(sim.model, PackedModel)
    tel = sim.run(3)
    assert all(t.pcg_converged for t in tel)
    assert np.isfinite(sim.stepper.displacement()).all()

