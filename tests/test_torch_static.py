"""Static mode of the port (``solver/static.py``, ``runner.run_static`` and
``--static``) against the JAX reference.

* ``solve_static`` on a 12^3 structured cantilever and on 6^3 hex and tet
  general boxes, against the reference's ``solve_static_jit`` (both
  classic on the CPU): u within 2.5e-4 of max|u| in nodal order, PCG
  iterations within +-1;
* ``static_oracle`` (the dense FP64 host solve) against the reference's at
  1e-10 of max|u|, and the PCG solve against it at 2.5e-4;
* the Dirichlet targets hold, the three PCG variants agree (fused and the
  whole-iteration loop run their plain forms here) and the true f64
  residual of a converged solve is small;
* the reference's two beam-theory checks (tests/test_validation_analytic.py)
  run through the port: hex general path and structured path within 10 %
  of Euler-Bernoulli + Timoshenko, and within 5e-3 of each other;
* the CLI's ``--static --output`` on examples/static_cantilever.yaml:
  exit 0, VTU frame 0, the telemetry payload's keys, max|u| within 2.5e-4
  of the reference runner's; exit 1 when the solve does not converge.

Inputs come from seeded numpy or from the same scenario in both packages.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from civiwave_tpu.mesh import pack as jpack
from civiwave_tpu.mesh import preprocess as jpreprocess
from civiwave_tpu.mesh import structured as jstructured
from civiwave_tpu.physics import materials as jmaterials
from civiwave_tpu.runner import main as jmain
from civiwave_tpu.solver.static import solve_static_jit, static_oracle as jstatic_oracle
from civiwave_tpu.utils import synthetic as jsynthetic
from civiwave_tpu_torch.mesh import pack, preprocess
from civiwave_tpu_torch.mesh import structured as tstructured
from civiwave_tpu_torch.physics import materials
from civiwave_tpu_torch.runner import build_simulation, main, run_static
from civiwave_tpu_torch.solver.static import (
    solve_static,
    static_oracle,
    true_relative_residual,
)
from civiwave_tpu_torch.utils import synthetic

from test_validation_analytic import _beam_theory_deflection

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATIC_YAML = os.path.join(REPO, "examples", "static_cantilever.yaml")
U_TOL = 2.5e-4  # BASELINE displacement tolerance, of max|u|
TOL = 1.0e-8  # the static tolerance of the example (its tol_pause)
E, NU, RHO, TRACTION = 2.0e11, 0.3, 7800.0, -1.0e6


def general_pair(nx, ny, nz, hex_elements, spacing=1.0):
    """Both packages' (mesh, preprocess, config, materials, model, force)
    of the steel cantilever over one box."""
    out = []
    for syn, pre_mod, mat_mod, pk, kw in (
        (synthetic, preprocess, materials, pack, dict(device="cpu")),
        (jsynthetic, jpreprocess, jmaterials, jpack, {}),
    ):
        cfg = syn.cantilever_config(traction=TRACTION)
        mesh = syn.box_mesh(nx, ny, nz, hex_elements=hex_elements, spacing=spacing)
        pre = pre_mod.run(mesh, cfg)
        mats = [mat_mod.make_properties(m) for m in cfg.materials]
        model, _, force = pk.build_packed_model(mesh, pre, cfg, mats, **kw)
        out.append((mesh, pre, cfg, mats, model, force))
    return out


def structured_pair(nx, ny, nz):
    """Both packages' (model, force) of the steel cantilever on a grid."""
    mat = synthetic.cantilever_config().materials[0]
    tm, tf = tstructured.build_structured_model(
        nx, ny, nz, materials.make_properties(mat), RHO,
        traction=(0.0, 0.0, TRACTION), device="cpu",
    )
    jm, jf = jstructured.build_structured_model(
        nx, ny, nz, jmaterials.make_properties(mat), RHO,
        traction=(0.0, 0.0, TRACTION),
    )
    return (tm, tf), (jm, jf)


def assert_u_close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=U_TOL * np.abs(ref).max())


@pytest.fixture(scope="module")
def grid12():
    """The 12^3 cantilever in both packages, the port's classic solve and
    the reference's classic and fused solves."""
    (tm, tf), (jm, jf) = structured_pair(12, 12, 12)
    u, tel = solve_static(tm, tf, tolerance=TOL)
    ref = {v: solve_static_jit(jm, jf, tolerance=TOL, variant=v)
           for v in ("classic", "fused")}
    return tm, tf, jm, (u, tel), ref


def test_solve_static_structured_matches_reference(grid12):
    tm, _, jm, (u, tel), ref = grid12
    ju, jtel = ref["classic"]
    assert tel.converged and bool(jtel.converged)
    assert abs(tel.iterations - int(jtel.iterations)) <= 1, (
        tel.iterations, int(jtel.iterations))
    assert_u_close(tm.to_nodal(u).numpy(), np.asarray(jm.to_nodal(ju)))


@pytest.mark.parametrize("hex_elements", [True, False], ids=["hex", "tet"])
def test_solve_static_general_matches_reference(hex_elements):
    (_, _, _, _, tm, tf), (_, _, _, _, jm, jf) = general_pair(6, 6, 6, hex_elements)
    u, tel = solve_static(tm, tf, tolerance=TOL)
    ju, jtel = solve_static_jit(jm, jf, tolerance=TOL)
    assert tel.converged and bool(jtel.converged)
    assert abs(tel.iterations - int(jtel.iterations)) <= 1, (
        tel.iterations, int(jtel.iterations))
    assert_u_close(tm.to_nodal(u).numpy(), np.asarray(jm.to_nodal(ju)))


@pytest.mark.parametrize("hex_elements", [True, False], ids=["hex", "tet"])
def test_static_oracle_matches_reference(hex_elements):
    (tmesh, tpre, tcfg, tmats, _, _), (jmesh, jpre, jcfg, jmats, _, _) = (
        general_pair(4, 2, 2, hex_elements)
    )
    got = static_oracle(tmesh, tpre, tcfg, tmats)
    ref = jstatic_oracle(jmesh, jpre, jcfg, jmats)
    assert got.shape == (tmesh.node_count, 3)
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("hex_elements", [True, False], ids=["hex", "tet"])
def test_static_solve_matches_dense_oracle(hex_elements):
    (mesh, pre, cfg, mats, model, force), _ = general_pair(4, 2, 2, hex_elements)
    u, tel = solve_static(model, force, tolerance=TOL)
    assert tel.converged
    assert_u_close(model.to_nodal(u).numpy(), static_oracle(mesh, pre, cfg, mats))


def test_static_dirichlet_targets_hold():
    (mesh, _, _, _, model, force), _ = general_pair(3, 2, 2, True)
    u, tel = solve_static(model, force, tolerance=TOL)
    assert tel.converged
    u_nodal = model.to_nodal(u).numpy()
    fixed = np.isclose(mesh.node_positions[:, 0], 0.0)
    np.testing.assert_array_equal(u_nodal[fixed], 0.0)
    assert np.abs(u_nodal[~fixed]).max() > 0.0


def test_static_rhs_takes_the_dirichlet_targets():
    """A nonzero target on a fixed plane is reached exactly (the rhs is
    clamped to bc_value, the constrained rows are identity rows)."""
    mat = synthetic.cantilever_config().materials[0]
    fixes = [("x0", (True, True, True), (None, None, None)),
             ("x1", (True, False, False), (1e-4, None, None))]
    model, force = tstructured.build_structured_model(
        6, 3, 3, materials.make_properties(mat), RHO, fixes=fixes, device="cpu"
    )
    u, tel = solve_static(model, force, tolerance=TOL)
    assert tel.converged
    np.testing.assert_array_equal(u[0, 6].numpy(), np.float32(1e-4))
    np.testing.assert_array_equal(u[:, 0].numpy(), 0.0)


@pytest.mark.parametrize("variant", ["fused", "mega"])
def test_static_variants_agree(variant, monkeypatch, grid12):
    """The fused (Chronopoulos-Gear) loop and the whole-iteration loop (K6's
    plain version here) against the reference's fused solve: iterations
    within +-1 (the recurrence needs more iterations than classic at 1e-8
    in f32 vectors, in both packages), u within 2.5e-4 of classic's, and a
    true f64 residual within 2x classic's (an f32 solution's residual
    floor, ~1e-4 here, not the recurred 1e-8)."""
    tm, tf, _, (u_c, tel_c), ref = grid12
    jtel = ref["fused"][1]
    if variant == "mega":
        monkeypatch.setenv("CIVIWAVE_MEGA_PCG", "1")
    u_v, tel_v = solve_static(tm, tf, tolerance=TOL, variant="fused")
    assert tel_c.converged and tel_v.converged and bool(jtel.converged)
    assert abs(tel_v.iterations - int(jtel.iterations)) <= 1, (
        tel_v.iterations, int(jtel.iterations))
    assert_u_close(u_v.numpy(), u_c.numpy())
    res_c = true_relative_residual(tm, tf, u_c)
    assert 0.0 < res_c < 1e-3
    assert true_relative_residual(tm, tf, u_v) < 2.0 * res_c


def test_true_relative_residual_of_the_zero_vector_is_one():
    (tm, tf), _ = structured_pair(4, 3, 3)
    zero = torch.zeros(tm.vector_shape)
    assert true_relative_residual(tm, tf, zero) == pytest.approx(1.0, rel=1e-12)


def test_solve_static_on_a_one_rank_shard_matches_unsharded():
    """A one-rank gloo shard solves ('auto' = fused, the dots through the
    group) to the unsharded fused solve's u (2 ranks:
    test_torch_general_sharded).  The counts are not held: the shard's
    plain operator (K5's) rounds otherwise than the unsharded one, and a
    solve to 1e-8 in f32 ends at that floor."""
    from civiwave_tpu_torch.parallel import sharding

    (tm, tf), _ = structured_pair(4, 3, 3)
    u_ref, tel_ref = solve_static(tm, tf, tolerance=TOL, variant="fused")
    try:
        group = sharding.make_shard_group(1, "cpu")
        shard, _, sf = sharding.shard_structured(tm, tm.zero_state(), tf, group)
        u, tel = solve_static(shard, sf, tolerance=TOL)
    finally:
        sharding.close_shard_group()
    assert tel.converged and tel_ref.converged
    assert_u_close(u.numpy(), u_ref.numpy())


@functools.lru_cache(maxsize=1)
def _tip_general(nx, ny, nz):
    (mesh, _, _, _, model, force), _ = general_pair(nx, ny, nz, True)
    u, tel = solve_static(model, force, tolerance=TOL)
    assert tel.converged
    tip = np.isclose(mesh.node_positions[:, 0], float(nx))
    return float(model.to_nodal(u).numpy()[tip, 2].mean())


def test_tip_deflection_hex_general_path():
    measured = _tip_general(30, 3, 3)
    analytic = _beam_theory_deflection(30.0, 3.0, 3.0, E, NU, TRACTION)
    assert abs(measured - analytic) / abs(analytic) < 0.10, (measured, analytic)


def test_tip_deflection_hex_structured_path():
    (tm, tf), _ = structured_pair(30, 3, 3)
    u, tel = solve_static(tm, tf, tolerance=TOL)
    assert tel.converged
    measured = float(tm.to_nodal(u).numpy().reshape(31, 4, 4, 3)[30, :, :, 2].mean())
    analytic = _beam_theory_deflection(30.0, 3.0, 3.0, E, NU, TRACTION)
    assert abs(measured - analytic) / abs(analytic) < 0.10, (measured, analytic)
    general = _tip_general(30, 3, 3)
    assert abs(measured - general) / abs(analytic) < 5e-3


def test_run_static_example_tip_deflection_and_state():
    """examples/static_cantilever.yaml through build_simulation and
    run_static: the structured route, the tip within 10 % of beam theory
    (the geometry of the analytic check scaled by 0.1), and the solution
    exposed as the stepper's state."""
    sim = build_simulation(STATIC_YAML, device="cpu")
    assert sim.structured
    u, payload = run_static(sim)
    assert payload["converged"] and payload["mode"] == "static"
    state = sim.stepper.state
    assert state.displacement is u and state.warm_x is u
    assert not state.velocity.any() and not state.acceleration.any()
    u_nodal = sim.stepper.displacement().reshape(31, 11, 11, 3)
    measured = float(u_nodal[30, :, :, 2].mean())
    analytic = _beam_theory_deflection(3.0, 1.0, 1.0, E, NU, TRACTION)
    assert abs(measured - analytic) / abs(analytic) < 0.10
    assert payload["max_displacement"] == pytest.approx(
        float(np.abs(u_nodal).max()), rel=1e-6)


PAYLOAD_KEYS = {"mode", "iterations", "residual_norm", "rhs_norm", "converged",
                "tolerance", "max_displacement", "elapsed_seconds"}


def test_cli_static_output_matches_reference(tmp_path, capsys):
    out, tel = tmp_path / "out", tmp_path / "static.json"
    rc = main([STATIC_YAML, "--static", "--output", str(out), "--device", "cpu",
               "--telemetry-json", str(tel)])
    assert rc == 0
    assert "static solve:" in capsys.readouterr().out
    assert os.path.isfile(out / "vtu" / "frame_00000.vtu")
    payload = json.loads(tel.read_text())
    assert set(payload) == PAYLOAD_KEYS
    assert payload["converged"] is True and payload["tolerance"] == TOL
    jtel = tmp_path / "jstatic.json"
    assert jmain([STATIC_YAML, "--static", "--telemetry-json", str(jtel)]) == 0
    ref = json.loads(jtel.read_text())
    assert set(ref) == PAYLOAD_KEYS
    assert abs(payload["max_displacement"] - ref["max_displacement"]) <= (
        U_TOL * ref["max_displacement"])


def test_cli_static_exit_1_when_not_converged(tmp_path):
    text = open(STATIC_YAML, encoding="utf-8").read()
    assert "max_iters: 4000" in text
    path = tmp_path / "few.yaml"
    path.write_text(text.replace("max_iters: 4000", "max_iters: 5").replace(
        "30,10,10,hex,0.1", "10,4,4,hex,0.1"))
    tel = tmp_path / "static.json"
    rc = main([str(path), "--static", "--device", "cpu", "--quiet",
               "--telemetry-json", str(tel)])
    assert rc == 1
    payload = json.loads(tel.read_text())
    assert payload["converged"] is False and payload["iterations"] == 5
