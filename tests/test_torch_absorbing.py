"""Lysmer-Kuhlemeyer absorbing faces on the port's structured route against
the JAX reference.

* the structured operator with the dashpot term (``damp_factor`` set) and
  ``absorbing_force`` on a 12x10x8 box with five absorbing faces, and on a
  padded box with fixes, at 1e-5 * max|ref| (also on the split route and
  through the (u, w) composition);
* the scenario front end and ``convert`` carry the absorbing fields (the
  converter used to drop them silently);
* the fused PCG loop composes the pc apply, the matvec and the dots when
  ``apply_pc_keff_dots`` declines (absorbing faces), iterations and x as
  the reference's fused solve;
* the stepper sets ``damp_factor`` per step on a copy of the model and
  builds the preconditioner once;
* 10 frames of ``examples/seismic_basin.yaml`` reduced to 12x12x6, on
  'classic' and 'fused', against the reference runner: iterations +-1, u
  at 2.5e-4 and a at 3e-3 of max|ref|.

Inputs come from seeded numpy and reach both packages as f32 arrays.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from civiwave_tpu.mesh.structured_config import try_build_structured as jtry_build
from civiwave_tpu.runner import build_simulation as jbuild_simulation
from civiwave_tpu.solver import pcg as jpcg
from civiwave_tpu.utils.synthetic import cantilever_config as jcantilever_config
from civiwave_tpu_torch import convert
from civiwave_tpu_torch.mesh.structured_config import try_build_structured
from civiwave_tpu_torch.ops import structured as tops
from civiwave_tpu_torch.runner import build_simulation
from civiwave_tpu_torch.solver import pcg as tpcg
from civiwave_tpu_torch.solver.stepper import effective_scalars
from civiwave_tpu_torch.utils.synthetic import cantilever_config

from test_torch_structured import JAX_ARRAYS, build_pair, to_port

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_TOL = 1e-5
U_TOL, A_TOL = 2.5e-4, 3e-3
DT = 2e-3
SS, MF = effective_scalars(DT, 0.0909, 3.64e-4)
A1 = np.float32(0.5 / (0.25 * DT))  # the Newmark a1 the stepper sets

FIVE = ("x0", "x1", "y0", "y1", "z0")
BOXES = {
    "five_faces": ((12, 10, 8), dict(absorb_planes=FIVE, fixed_axis_planes=())),
    "xpad_fixes": ((7, 5, 4), dict(
        absorb_planes=("x1", "y0", "z1"), pad_x_multiple=4,
        fixes=[("x0", (True, True, True), (None, None, None)),
               ("z1", (True, False, True), (None, None, None))],
    )),
}


def _soil_pair(case):
    dims, kw = BOXES[case]
    return build_pair(dims, kw)


def _x(shape, seed=17):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_close(out, ref, rel=OP_TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0.0,
                               atol=rel * (np.abs(ref).max() + 1e-30))


def _damped(jm, tm):
    return (dataclasses.replace(jm, damp_factor=jnp.float32(A1)),
            dataclasses.replace(tm, damp_factor=float(A1)))


@pytest.mark.parametrize("case", sorted(BOXES))
def test_absorbing_operator_and_force_match_reference(case):
    jm, _, tm, _ = _soil_pair(case)
    assert tm.absorb_faces == jm.absorb_faces
    assert (tm.rho_cp, tm.rho_cs) == (jm.rho_cp, jm.rho_cs)
    jd, td = _damped(jm, tm)
    x = _x(jm.vector_shape)
    ref = np.asarray(jd.apply_keff(jnp.asarray(x), SS, MF))
    out = td.apply_keff(torch.from_numpy(x), SS, MF).numpy()
    _assert_close(out, ref)
    # the term is there: the undamped operator differs on the faces
    undamped = tm.apply_keff(torch.from_numpy(x), SS, MF).numpy()
    assert np.abs(undamped - out).max() > 1e-3 * np.abs(out).max()
    bc = np.asarray(jm.bc_mask)
    np.testing.assert_array_equal(out[bc], x[bc])
    _assert_close(
        tm.absorbing_force(torch.from_numpy(x)).numpy(),
        np.asarray(jm.absorbing_force(jnp.asarray(x))),
    )


@pytest.mark.parametrize("case", sorted(BOXES))
def test_absorbing_term_on_the_split_route_and_pc_keff(case, monkeypatch):
    jm, _, tm, _ = _soil_pair(case)
    jd, td = _damped(jm, tm)
    x = _x(jm.vector_shape, seed=4)
    ref = np.asarray(jd.apply_keff(jnp.asarray(x), SS, MF))
    jpc = jm.build_preconditioner(SS, MF)
    ju, jw = jd.apply_pc_keff(jpc, jnp.asarray(x), SS, MF)
    tpc = tm.build_preconditioner(SS, MF)
    # K1 route: K2's (u, w) plus the term on w
    tu, tw = td.apply_pc_keff(tpc, torch.from_numpy(x), SS, MF)
    _assert_close(tu.numpy(), np.asarray(ju))
    _assert_close(tw.numpy(), np.asarray(jw))
    monkeypatch.setattr(tops, "_FLAT_INTERIOR_NODE_THRESHOLD", 0)
    assert tops.slender_route(td, torch.float32)
    _assert_close(td.apply_keff(torch.from_numpy(x), SS, MF).numpy(), ref)
    tu, tw = td.apply_pc_keff(tpc, torch.from_numpy(x), SS, MF)
    _assert_close(tw.numpy(), np.asarray(jw))


def test_front_end_carries_the_absorbing_faces():
    node = dict(
        mesh={"path": "synthetic://box/6,3,4"},
        boundaries={"absorbing": ["SIDE_X1", "SIDE_Y0", "SIDE_Z0"]},
    )
    tm, _ = try_build_structured(cantilever_config(**node), device="cpu")
    jm, _ = jtry_build(jcantilever_config(**node))
    assert tm.absorb_faces == jm.absorb_faces == ("x1", "y0", "z0")
    assert (tm.rho_cp, tm.rho_cs) == (jm.rho_cp, jm.rho_cs) and tm.rho_cp > 0
    for name in JAX_ARRAYS:
        np.testing.assert_array_equal(
            getattr(tm, name).numpy(), np.asarray(getattr(jm, name)))


def test_convert_carries_the_absorbing_fields():
    """The converter used to drop absorb_faces/rho_cp/rho_cs silently, so a
    carried model lost its dashpots; now the operator with damp_factor set
    matches the reference's."""
    jm, _, _, _ = _soil_pair("five_faces")
    tc = to_port(jm)
    assert tc.absorb_faces == FIVE
    assert (tc.rho_cp, tc.rho_cs) == (jm.rho_cp, jm.rho_cs)
    jd, td = _damped(jm, tc)
    x = _x(jm.vector_shape, seed=2)
    _assert_close(td.apply_keff(torch.from_numpy(x), SS, MF).numpy(),
                  np.asarray(jd.apply_keff(jnp.asarray(x), SS, MF)))
    # the packed-model converter carries the halo tables too, all or none
    # (test_torch_general_sharded); the general path's dashpots are carried
    # (test_torch_general_absorbing)
    with pytest.raises(ValueError, match="halo"):
        convert.packed_model_from_arrays({"halo_conn": np.zeros((4, 4))}, {}, "cpu")


def test_fused_loop_composes_when_dots_decline(monkeypatch):
    jm, jf, tm, _ = _soil_pair("xpad_fixes")
    jd, td = _damped(jm, tm)
    rng = np.random.default_rng(8)
    rhs = (np.asarray(jf) + 1e3 * rng.standard_normal(jm.vector_shape)).astype(np.float32)
    rhs = np.where(np.asarray(jm.bc_mask), np.asarray(jm.bc_value), rhs).astype(np.float32)
    x0 = np.zeros(jm.vector_shape, np.float32)
    seen = []
    real = type(td).apply_pc_keff_dots

    def spy(self, *args):
        out = real(self, *args)
        seen.append(out)
        return out

    monkeypatch.setattr(type(td), "apply_pc_keff_dots", spy)
    xt, telt = tpcg.solve_pcg(
        td, torch.from_numpy(rhs), SS, MF, 1e-6, 200, torch.from_numpy(x0),
        variant="fused",
    )
    assert seen and all(out is None for out in seen)
    xj, telj = jpcg.solve_pcg(
        jd, jnp.asarray(rhs), SS, MF, 1e-6, 200, jnp.asarray(x0),
        variant="fused",
    )
    assert abs(telt.iterations - int(telj.iterations)) <= 1
    assert telt.converged and bool(telj.converged)
    _assert_close(xt.numpy(), np.asarray(xj), rel=2e-5)


def test_stepper_sets_damp_factor_and_builds_the_pc_once(monkeypatch):
    cfg = cantilever_config(
        mesh={"path": "synthetic://box/5,3,3"}, tol_runtime=2e-4,
        max_iters=120, dt=DT, boundaries={"absorbing": ["SIDE_X1"]},
    )
    sim = build_simulation(cfg, device="cpu")
    model = sim.stepper.model
    builds, factors = [], []
    real_build = type(model).build_preconditioner
    real_apply = type(model).apply_keff
    monkeypatch.setattr(type(model), "build_preconditioner",
                        lambda self, *a: (builds.append(1), real_build(self, *a))[1])
    monkeypatch.setattr(type(model), "apply_keff",
                        lambda self, *a: (factors.append(self.damp_factor),
                                          real_apply(self, *a))[1])
    tel = sim.run(3)
    assert all(t.pcg_converged for t in tel)
    assert len(builds) == 1
    assert sim.stepper.model.damp_factor is None
    # the Rayleigh-beta matvec runs on the undamped model, the solve on
    # the step's copy with a1
    assert set(factors) == {None, float(A1)}


@pytest.mark.parametrize("variant", ["classic", "fused"])
def test_seismic_basin_trajectory_matches_reference(variant, tmp_path):
    with open(os.path.join(REPO, "examples", "seismic_basin.yaml"),
              encoding="utf-8") as f:
        text = f.read()
    assert "synthetic://box/48,48,24" in text and "max_iters: 120" in text
    text = text.replace("synthetic://box/48,48,24", "synthetic://box/12,12,6")
    text = text.replace("max_iters: 120", f"max_iters: 120\n  variant: {variant}")
    path = tmp_path / "basin.yaml"
    path.write_text(text)
    sim = build_simulation(str(path), device="cpu")
    assert sim.model.absorb_faces == FIVE
    assert sim.stepper.solver_variant == variant
    tel = sim.run(10)
    jsim = jbuild_simulation(str(path))
    jtel = jsim.run(10)
    iters = [t.pcg_iterations for t in tel]
    jiters = [t.pcg_iterations for t in jtel]
    assert all(abs(a - b) <= 1 for a, b in zip(iters, jiters)), (iters, jiters)
    assert all(t.pcg_converged for t in tel) and sum(iters) > 0
    for name, tol in (("displacement", U_TOL), ("acceleration", A_TOL)):
        ref = np.asarray(getattr(jsim.stepper.state, name))
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(
            getattr(sim.stepper.state, name).numpy(), ref, rtol=0.0,
            atol=tol * np.abs(ref).max(), err_msg=name,
        )
