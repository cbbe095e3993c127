"""PCG and the Newmark step on the port's general path.

* ``solve_pcg`` classic and fused (the fused variant composes
  ``apply_pc_keff`` with ``fused_dots`` on a model without a fused kernel)
  against the reference's on a model carried across through ``convert``:
  iterations within +-1, solutions at 1e-4 * max|ref| (tests/test_pcg.py:313);
* ``auto`` is classic on the general path, as in the reference;
* three Newmark frames of the port's stepper against the port's dense FP64
  oracle (``physics/oracle.py``, ``physics/newmark.py``) at the reference
  engine's stepper-test tolerances (3e-4 displacement, 3e-3 velocity and
  acceleration of max|ref|; newmark_stepper_test.cpp:230-238).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from civiwave_tpu.solver.pcg import solve_pcg as jsolve_pcg
from civiwave_tpu_torch.mesh import pack, preprocess
from civiwave_tpu_torch.physics import materials, newmark, oracle
from civiwave_tpu_torch.solver.pcg import solve_pcg
from civiwave_tpu_torch.solver.stepper import NewmarkStepper, effective_scalars
from civiwave_tpu_torch.utils.synthetic import box_mesh, cantilever_config
from torch_general_support import model_pair, to_port_packed

torch.set_num_threads(2)

SOL_TOL = 1e-4


def _system(kind):
    _, (_, _, jc, jm, jforce) = model_pair(kind)
    tm = to_port_packed(jm)
    ray = materials.compute_rayleigh(jc.damping)
    ss, mf = effective_scalars(1.0e-3, ray.alpha, ray.beta)
    rhs = np.random.default_rng(9).standard_normal(tm.vector_shape).astype(np.float32)
    rhs = rhs * np.float32(1e5) + np.asarray(jforce)
    rhs[tm.bc_mask.numpy()] = 0.0
    return jm, tm, ss, mf, rhs


@pytest.mark.parametrize("variant", ["classic", "fused"])
@pytest.mark.parametrize("kind", ["tet", "mixed", "column"])
def test_pcg_variants_match_the_reference(kind, variant):
    jm, tm, ss, mf, rhs = _system(kind)
    x0 = np.zeros(tm.vector_shape, np.float32)
    ref, ref_tel = jsolve_pcg(
        jm, jnp.asarray(rhs), ss, mf, 2.0e-4, 300, jnp.asarray(x0),
        warm_start=False, variant=variant,
    )
    ours, tel = solve_pcg(
        tm, torch.as_tensor(rhs), ss, mf, 2.0e-4, 300, torch.as_tensor(x0),
        warm_start=False, variant=variant,
    )
    assert tel.converged and bool(ref_tel.converged)
    assert abs(tel.iterations - int(ref_tel.iterations)) <= 1
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        ours.numpy(), ref, rtol=0, atol=SOL_TOL * np.abs(ref).max()
    )


def test_auto_is_classic_on_the_general_path():
    _, tm, ss, mf, rhs = _system("tet")
    x0 = torch.zeros(tm.vector_shape)
    auto, tel_auto = solve_pcg(
        tm, torch.as_tensor(rhs), ss, mf, 2.0e-4, 300, x0, variant="auto"
    )
    classic, tel_classic = solve_pcg(
        tm, torch.as_tensor(rhs), ss, mf, 2.0e-4, 300, x0, variant="classic"
    )
    assert not tm.prefers_fused_pcg(None, torch.float32)
    assert tel_auto.iterations == tel_classic.iterations
    assert torch.equal(auto, classic)


@pytest.mark.parametrize("hex_elements", [False, True], ids=["tet", "hex"])
def test_step_matches_the_dense_oracle(hex_elements):
    cfg = cantilever_config(tol_runtime=1e-6, max_iters=1000, dt=1e-3)
    mesh = box_mesh(3, 1, 1, hex_elements=hex_elements)
    pre = preprocess.run(mesh, cfg)
    mats = [materials.make_properties(m) for m in cfg.materials]
    ray = materials.compute_rayleigh(cfg.damping)
    model, state, force = pack.build_packed_model(mesh, pre, cfg, mats, device="cpu")
    stepper = NewmarkStepper(model, state, force, ray, cfg.solver, cfg.time)

    assembly = oracle.assemble_linear_system(mesh, pre, mats)
    dirichlet = oracle.build_dirichlet_conditions(mesh, cfg)
    dense_state = newmark.State.zeros(mesh.dof_count)
    load = model.to_nodal(force).numpy().reshape(-1).astype(np.float64)
    for frame in range(3):
        coeffs = newmark.make_coefficients(stepper.current_dt)
        rhs_norm = np.linalg.norm(newmark.build_effective_rhs(
            load, assembly.stiffness, assembly.mass_diag, ray, coeffs, dense_state
        ))
        dense = oracle.solve_newmark_step(
            assembly, ray, dirichlet, mesh, cfg, pre, coeffs, dense_state,
            frame * stepper.current_dt, 1.0e-8 * max(rhs_norm, 1.0), 4000,
            external_load=load,
        )
        assert dense.stats.converged
        telemetry = stepper.step(frame * stepper.current_dt)
        assert telemetry.pcg_converged and not telemetry.pcg_breakdown
        for name, tol in (("displacement", 3e-4), ("velocity", 3e-3),
                          ("acceleration", 3e-3)):
            ref = getattr(dense.state, name)
            got = getattr(stepper, name)().reshape(-1)
            np.testing.assert_allclose(
                got, ref, rtol=0, atol=tol * (np.abs(ref).max() + 1e-30),
                err_msg=f"frame {frame} {name}",
            )
        dense_state = dense.state
