"""PCG of the port against the JAX reference on structured models: the
classic and the Chronopoulos-Gear (fused) loops (the pipelined loop:
tests/test_torch_pipelined.py), the 'auto' policy on the
CPU, a zero right-hand side, max_iterations = 0 and the telemetry fields.
Tolerances: iterations within +-1 (equality expected), solution at
1e-4 * max|ref| (tests/test_pcg.py:313), dots at rtol 1e-6 (f32 chunk
partials summed in another order).  The fused loop, whose p/s update runs
at the top of the next iteration, against the form that updated p and s
right after the flag read: bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from civiwave_tpu.solver import pcg as jpcg
from civiwave_tpu_torch.mesh import pack, preprocess
from civiwave_tpu_torch.physics import materials
from civiwave_tpu_torch.solver import pcg as tpcg
from civiwave_tpu_torch.solver.stepper import effective_scalars
from civiwave_tpu_torch.utils.synthetic import box_mesh, cantilever_config

from test_torch_structured import build_pair

torch.set_num_threads(2)

SOL_TOL = 1e-4
# a realistic Newmark system: dt = 1 ms on steel, Rayleigh from the
# cantilever scenario (xi 0.02 at 10/100 rad/s)
SS, MF = effective_scalars(1e-3, 0.36363636, 3.6363636e-4)


def _problem(dims=(6, 4, 3), seed=21, **kw):
    kw.setdefault("fixed_axis_planes", ("x0",))
    kw.setdefault("traction", (0.0, 0.0, -1e6))
    jm, jf, tm, tf = build_pair(dims, kw)
    rng = np.random.default_rng(seed)
    # rhs: the traction force plus noise, Dirichlet-clamped to the targets
    rhs = np.asarray(jf) + 1e3 * rng.standard_normal(jm.vector_shape).astype(np.float32)
    rhs = np.where(np.asarray(jm.bc_mask), np.asarray(jm.bc_value), rhs)
    rhs = rhs.astype(np.float32)
    x0 = (1e-6 * rng.standard_normal(jm.vector_shape)).astype(np.float32)
    return jm, tm, rhs, x0


@functools.lru_cache(maxsize=None)
def _jax_solver(variant, rdt):
    """The reference solve, jitted once per (variant, reduction dtype) with
    the model, vectors, tolerance and cap as arguments."""
    return jax.jit(functools.partial(
        jpcg.solve_pcg, reduction_dtype=rdt, variant=variant
    ))


def _jax_solve(jm, rhs, tol, max_it, x0, variant, rdt=jnp.float64):
    return _jax_solver(variant, rdt)(
        jm, jnp.asarray(rhs), SS, MF, jnp.float64(tol), jnp.int32(max_it),
        jnp.asarray(x0),
    )


def _solve_both(variant, tol=1e-6, max_it=200, rhs_scale=1.0, rdt="fp64", **kw):
    jm, tm, rhs, x0 = _problem(**kw)
    rhs = (rhs * rhs_scale).astype(np.float32)
    jdt = jnp.float32 if rdt == "fp32" else jnp.float64
    tdt = torch.float32 if rdt == "fp32" else torch.float64
    # the reference's 'auto' is classic on the CPU (its fused kernels are
    # TPU-only); reuse that compiled solve
    jvariant = "classic" if variant == "auto" else variant
    xj, telj = _jax_solve(jm, rhs, tol, max_it, x0, jvariant, jdt)
    xt, telt = tpcg.solve_pcg(
        tm, torch.from_numpy(rhs), SS, MF, tol, max_it, torch.from_numpy(x0),
        reduction_dtype=tdt, variant=variant,
    )
    return np.asarray(xj), telj, xt.numpy(), telt, tm


@pytest.mark.parametrize("variant", ["classic", "fused", "auto"])
def test_solution_and_telemetry_match_reference(variant):
    xj, telj, xt, telt, tm = _solve_both(variant)
    assert telt.converged and bool(telj.converged)
    assert not telt.breakdown and not bool(telj.breakdown)
    assert abs(telt.iterations - int(telj.iterations)) <= 1
    assert telt.iterations > 3
    np.testing.assert_allclose(
        xt, xj, rtol=0.0, atol=SOL_TOL * np.abs(xj).max()
    )
    # constrained components carry the rhs targets exactly
    bc = tm.bc_mask.numpy()
    np.testing.assert_array_equal(xt[bc], xj[bc])
    assert float(telt.rhs_norm) == pytest.approx(float(telj.rhs_norm), rel=1e-6)
    assert float(telt.residual_norm) <= 1e-6 * float(telt.rhs_norm)
    assert float(telt.residual_norm) == pytest.approx(
        float(telj.residual_norm), rel=0.5
    )
    for field in ("alpha_last", "beta_last"):
        assert float(getattr(telt, field)) == pytest.approx(
            float(getattr(telj, field)), rel=0.05
        ), field
    for field in ("residual_norm", "rhs_norm", "alpha_last", "beta_last"):
        assert getattr(telt, field).dtype == torch.float64


def test_auto_is_classic_on_cpu():
    """'auto' takes the fused loop only where the fused kernel runs (CUDA,
    f32); on the CPU it is classic, exactly as the reference picks there."""
    _, _, xa, ta, tm = _solve_both("auto")
    _, _, xc, tc, _ = _solve_both("classic")
    assert ta.iterations == tc.iterations
    np.testing.assert_array_equal(xa, xc)
    pc = tm.build_preconditioner(SS, MF)
    assert not tm.prefers_fused_pcg(pc, torch.float32)


@pytest.mark.parametrize("variant", ["classic", "fused"])
def test_zero_rhs_converges_immediately(variant):
    jm, tm, _, _ = _problem()
    zeros = np.zeros(jm.vector_shape, np.float32)
    xj, telj = _jax_solve(jm, zeros, 1e-6, 50, zeros, variant)
    xt, telt = tpcg.solve_pcg(
        tm, torch.from_numpy(zeros), SS, MF, 1e-6, 50, torch.from_numpy(zeros),
        variant=variant,
    )
    assert telt.iterations == int(telj.iterations) == 0
    assert telt.converged and bool(telj.converged)
    assert not xt.any() and not np.asarray(xj).any()
    assert float(telt.rhs_norm) == 0.0


@pytest.mark.parametrize("variant, rdt", [("classic", "fp32"), ("fused", "fp64")])
def test_max_iterations_caps_and_reduction_dtype(variant, rdt):
    xj, telj, xt, telt, _ = _solve_both(variant, tol=1e-12, max_it=5, rdt=rdt)
    assert telt.iterations == int(telj.iterations) == 5
    assert not telt.converged and not bool(telj.converged)
    assert telt.residual_norm.dtype == (
        torch.float32 if rdt == "fp32" else torch.float64
    )
    np.testing.assert_allclose(xt, xj, rtol=0.0, atol=1e-3 * np.abs(xj).max())
    _, telj0, _, telt0, _ = _solve_both(variant, max_it=0)
    assert telt0.iterations == int(telj0.iterations) == 0
    assert telt0.converged == bool(telj0.converged) is False
    assert float(telt0.residual_norm) == pytest.approx(
        float(telj0.residual_norm), rel=1e-6
    )


def test_pipelined_variant_raises_until_ported():
    """Ported since: 'pipelined' solves (tests/test_torch_pipelined.py holds
    it to the reference) and an unknown variant still raises."""
    _, tm, rhs, x0 = _problem()
    x, tel = tpcg.solve_pcg(
        tm, torch.from_numpy(rhs), SS, MF, 1e-6, 200, torch.from_numpy(x0),
        variant="pipelined",
    )
    assert tel.converged and not tel.breakdown and tel.iterations > 3
    with pytest.raises(ValueError, match="unknown PCG variant"):
        tpcg.solve_pcg(
            tm, torch.from_numpy(rhs), SS, MF, 1e-6, 10, torch.from_numpy(x0),
            variant="pipelinedd",
        )


def test_dots_match_reference():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 7, 6, 5)).astype(np.float32)
    b = rng.standard_normal((3, 7, 6, 5)).astype(np.float32)
    ours = tpcg.dot_f64(torch.from_numpy(a), torch.from_numpy(b))
    ref = jpcg.dot_f64(jnp.asarray(a), jnp.asarray(b))
    assert ours.dtype == torch.float64
    # the f32 chunk partials round in another order: ~1e-7 relative
    assert float(ours) == pytest.approx(float(ref), rel=1e-6)
    fused = tpcg.fused_dots(
        [(torch.from_numpy(a), torch.from_numpy(b)),
         (torch.from_numpy(a), torch.from_numpy(a))]
    )
    ref_f = jpcg.fused_dots(
        [(jnp.asarray(a), jnp.asarray(b)), (jnp.asarray(a), jnp.asarray(a))]
    )
    np.testing.assert_allclose(fused.numpy(), np.asarray(ref_f), rtol=1e-6)
    assert float(tpcg.dot_f64(
        torch.from_numpy(a), torch.from_numpy(b), torch.float32
    )) == pytest.approx(float(ref), rel=1e-5)


def _fused_update_after_sync(model, rhs, ss, mf, rel_tol, max_it, x0):
    """The Chronopoulos-Gear loop as it was before its p/s update moved to
    the top of the next iteration: p and s updated right after the flag
    read (the reference for the deferred form; no K6, f64 reductions, f32
    vectors, warm start)."""
    f32, rdt, bc = torch.float32, torch.float64, model.bc_mask
    block_inverse = model.build_preconditioner(ss, mf)
    x = x0
    r = (rhs - model.apply_keff(x, ss, mf)).to(f32)
    x, r = tpcg._clamp_dirichlet(model, rhs, x, r)
    u, w = model.apply_pc_keff(block_inverse, r, ss, mf)
    gamma, delta0, rr0, rhs2 = tpcg.fused_dots([(r, u), (w, u), (r, r), (rhs, rhs)], rdt)
    rhs_norm_true = torch.sqrt(rhs2)
    rhs_norm = torch.where(rhs_norm_true < tpcg._RHS_NORM_FLOOR, 1.0, rhs_norm_true)
    tolerance = rel_tol * rhs_norm
    residual_norm = torch.sqrt(rr0)
    delta_small = delta0.abs() < tpcg._BREAKDOWN_TOL
    alpha = gamma / torch.where(delta_small, 1.0, delta0)
    converged, delta_bd = tpcg._flags(residual_norm <= tolerance, delta_small)
    breakdown = (not converged) and delta_bd
    p = u.masked_fill(bc, 0.0).to(f32)
    s = w.masked_fill(bc, 0.0).to(f32)
    alpha_last = torch.zeros((), dtype=rdt)
    beta_last = torch.zeros((), dtype=rdt)
    iteration = 0
    while iteration < max_it and not converged and not breakdown:
        alpha32 = alpha.to(f32)
        x = x + alpha32 * p
        r = r - alpha32 * s
        u, w = model.apply_pc_keff(block_inverse, r, ss, mf)
        gamma_new, delta, rr = tpcg.fused_dots([(r, u), (w, u), (r, r)], rdt)
        residual_norm = torch.sqrt(rr)
        gamma_small = gamma.abs() < tpcg._BREAKDOWN_TOL
        beta = gamma_new / torch.where(gamma_small, 1.0, gamma)
        alpha_denom = delta - beta * gamma_new / torch.where(
            alpha.abs() < tpcg._BREAKDOWN_TOL, 1.0, alpha)
        denom_small = alpha_denom.abs() < tpcg._BREAKDOWN_TOL
        alpha_new = gamma_new / torch.where(denom_small, 1.0, alpha_denom)
        conv, g_bd, d_bd = tpcg._flags(residual_norm <= tolerance, gamma_small,
                                       denom_small)
        alpha_last = alpha
        iteration += 1
        converged = conv
        breakdown = (not conv) and (g_bd or d_bd)
        if not (converged or breakdown):
            beta32 = beta.to(f32)
            p = (u + beta32 * p).masked_fill(bc, 0.0)
            s = (w + beta32 * s).to(f32).masked_fill(bc, 0.0)
            gamma, alpha, beta_last = gamma_new, alpha_new, beta
    return x, tpcg.PcgTelemetry(iteration, residual_norm, rhs_norm_true,
                                alpha_last, beta_last, converged, breakdown)


def _general_problem(seed=5):
    """A tet box on the general path: its load plus noise, clamped to the
    fixed components' zero targets, and a small random start."""
    cfg = cantilever_config()
    mesh = box_mesh(5, 3, 3)
    mats = [materials.make_properties(m) for m in cfg.materials]
    model, _, force = pack.build_packed_model(
        mesh, preprocess.run(mesh, cfg), cfg, mats, device="cpu")
    rng = np.random.default_rng(seed)
    rhs = force.numpy() + 1e3 * rng.standard_normal(force.shape).astype(np.float32)
    rhs = np.where(model.bc_mask.numpy(), 0.0, rhs).astype(np.float32)
    x0 = (1e-6 * rng.standard_normal(force.shape)).astype(np.float32)
    return model, rhs, x0


@pytest.mark.parametrize("case", ["structured", "general", "stops_at_setup",
                                  "max_iterations"])
def test_fused_deferred_update_is_bit_equal(case):
    """The fused loop with its p/s update deferred to the top of the next
    iteration gives the same x bit for bit, the same iterations and the
    same telemetry as the update right after the flag read."""
    tol, max_it = 1e-6, 200
    if case == "general":
        model, rhs, x0 = _general_problem()
    else:
        _, model, rhs, x0 = _problem()
    if case == "stops_at_setup":
        rhs, x0 = np.zeros_like(rhs), np.zeros_like(x0)
    if case == "max_iterations":
        tol, max_it = 1e-12, 5
    rhs_t, x0_t = torch.from_numpy(rhs), torch.from_numpy(x0)
    x, tel = tpcg.solve_pcg(model, rhs_t, SS, MF, tol, max_it, x0_t.clone(),
                            variant="fused")
    x_ref, tel_ref = _fused_update_after_sync(model, rhs_t, SS, MF, tol, max_it, x0_t)
    assert torch.equal(x, x_ref)
    assert (tel.iterations, tel.converged, tel.breakdown) == (
        tel_ref.iterations, tel_ref.converged, tel_ref.breakdown)
    for field in ("residual_norm", "rhs_norm", "alpha_last", "beta_last"):
        assert torch.equal(getattr(tel, field), getattr(tel_ref, field)), field
    want = {"structured": tel.iterations > 3, "general": tel.iterations > 3,
            "stops_at_setup": tel.iterations == 0 and tel.converged,
            "max_iterations": tel.iterations == 5 and not tel.converged}
    assert want[case]
