"""The whole-iteration PCG path of the port (K6 and the megafused loop)
against the JAX reference.

* one iteration of the plain K6 against the reference's Pallas kernel
  ``pcg_iteration_fused_pallas`` in interpret mode, on the x_ext-padded
  carries the reference needs (even plane counts): vectors at
  2e-5 * max|ref| (tests/test_structured.py:510), dots at rel 1e-5;
* the plain K6 on grids the reference refuses (odd plane count, +X pad
  planes) against the port's own composition at 1e-6 * max|ref|, and its
  operator output against the numpy emulation of the class-table
  arithmetic the CUDA kernels run at 1e-5 * max|ref|;
* the megafused loop (``CIVIWAVE_MEGA_PCG=1``) against the reference's
  split ``solve_pcg_fused``: iterations within +-1, x at 2e-5 * max|ref|,
  equal converged/breakdown flags (tests/test_pcg.py:544-589);
* the fused loop with and without the switch: each body once per
  iteration, x bit-equal between the two, and the iteration count and x
  the two loops gave before they were folded into one;
* 6 Newmark frames of a 12^3 cantilever on variant 'fused' against the
  reference stepper, at the BASELINE stepping tolerances (u 2.5e-4 and
  a 3e-3 of max|ref|, iterations +-1 per frame);
* the gating: the switch, the model kind and the vector dtype.

Inputs come from seeded numpy and reach both packages as f32 arrays.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from civiwave_tpu.mesh.structured_config import try_build_structured as jtry_build
from civiwave_tpu.ops import structured as jops
from civiwave_tpu.ops.pallas.structured_stencil import (
    _pick_block,
    pcg_iteration_fused_pallas,
)
from civiwave_tpu.physics import materials as jmaterials
from civiwave_tpu.solver import pcg as jpcg
from civiwave_tpu.solver.stepper import NewmarkStepper as JNewmarkStepper
from civiwave_tpu.utils.synthetic import cantilever_config as jcantilever_config
from civiwave_tpu_torch.mesh.pack import PackedModel
from civiwave_tpu_torch.ops import structured as tops
from civiwave_tpu_torch.ops.cuda import pcg_iteration as k6
from civiwave_tpu_torch.physics import materials
from civiwave_tpu_torch.runner import build_simulation
from civiwave_tpu_torch.solver import pcg as tpcg
from civiwave_tpu_torch.solver.stepper import NewmarkStepper, effective_scalars
from civiwave_tpu_torch.utils.synthetic import cantilever_config

from test_torch_structured import build_pair, emulate_keff, to_port

torch.set_num_threads(2)

VEC_TOL, DOT_RTOL = 2e-5, 1e-5
# a realistic Newmark system: dt = 1 ms on steel, Rayleigh from the
# cantilever scenario (xi 0.02 at 10/100 rad/s)
SS, MF = effective_scalars(1e-3, 0.36363636, 3.6363636e-4)
ALPHA, BETA = np.float32(0.3), np.float32(0.2)
NAMES = ("x", "r", "u", "w", "p", "s")
PARTIAL_FIXES = dict(fixes=[
    ("x0", (True, True, True), (None, None, None)),
    ("y1", (False, True, False), (None, None, None)),
    ("z0", (True, False, True), (None, None, None)),
])
GRIDS = {
    "5x4x3_x0": ((5, 4, 3), dict(fixed_axis_planes=("x0",))),
    "7x5x4_partial": ((7, 5, 4), PARTIAL_FIXES),
    "4x3x2_odd": ((4, 3, 2), dict(fixed_axis_planes=("x0", "z1"))),
    "6x5x4_xpad4": ((6, 5, 4), dict(pad_x_multiple=4, **PARTIAL_FIXES)),
}


def _carries(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in NAMES]


def _close(out, ref, rel, name=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, name
    np.testing.assert_allclose(
        out, ref, rtol=0.0, atol=rel * (np.abs(ref).max() + 1e-30), err_msg=name
    )


def _plain(tm, pc, carries, alpha, beta):
    return k6.pcg_iteration_fused_plain(
        tm, pc.table, tuple(torch.from_numpy(c) for c in carries),
        torch.tensor(alpha), torch.tensor(beta), SS, MF,
    )


@pytest.mark.parametrize(
    "grid, beta",
    [("5x4x3_x0", BETA), ("5x4x3_x0", np.float32(0.0)), ("7x5x4_partial", BETA)],
    ids=["5x4x3_x0", "5x4x3_x0_beta0", "7x5x4_partial"],
)
def test_plain_iteration_matches_reference_kernel(grid, beta):
    dims, kw = GRIDS[grid]
    jm, _, tm, _ = build_pair(dims, kw)
    x_planes = jm.grid_shape[0]
    block = _pick_block(x_planes)
    assert block > 1  # an even plane count, as the reference requires
    carries = _carries(jm.vector_shape, seed=31)
    pcj = jm.build_preconditioner(SS, MF)
    pad = ((0, 0), (1, block - 1), (0, 0), (0, 0))
    tables = jops._stencil_tables(jm.spacing, jm.lam0, jm.mu0)
    outs, pa, pb = pcg_iteration_fused_pallas(
        jm, pcj.table, tuple(jnp.asarray(np.pad(c, pad)) for c in carries),
        ALPHA, beta, SS, MF, tables, interpret=True,
    )
    refs = [np.asarray(o)[:, 1:1 + x_planes] for o in outs]
    ref_dots = (
        float(jnp.sum(pa[:, 0].astype(jnp.float64))),
        float(jnp.sum(pb[:, 0].astype(jnp.float64))),
        float(jnp.sum(pa[:, 1].astype(jnp.float64))),
    )

    pc = tm.build_preconditioner(SS, MF)
    np.testing.assert_array_equal(pc.table.numpy(), np.asarray(pcj.table))
    ours, dots = _plain(tm, pc, carries, ALPHA, beta)
    for name, out, ref in zip(NAMES, ours, refs):
        _close(out.numpy(), ref, VEC_TOL, name)
    for name, got, ref in zip(("gamma", "delta", "rr"), dots, ref_dots):
        assert got.dtype == torch.float64
        assert float(got) == pytest.approx(ref, rel=DOT_RTOL), name


@pytest.mark.parametrize("grid", ["4x3x2_odd", "6x5x4_xpad4"])
def test_plain_iteration_on_grids_the_reference_refuses(grid):
    dims, kw = GRIDS[grid]
    _, _, tm, _ = build_pair(dims, kw)
    pc = tm.build_preconditioner(SS, MF)
    carries = _carries(tm.vector_shape, seed=5)
    ours, dots = _plain(tm, pc, carries, ALPHA, BETA)

    # the port's own composition, written out
    x, r, u, w, p, s = (torch.from_numpy(c) for c in carries)
    bc = tm.bc_mask
    zero = torch.zeros(())
    alpha, beta = float(ALPHA), float(BETA)
    p1 = torch.where(bc, zero, u + beta * p)
    s1 = torch.where(bc, zero, w + beta * s)
    x1 = x + alpha * p1
    r1 = r - alpha * s1
    u1 = tm.apply_preconditioner(pc, r1)
    w1 = tm.apply_keff(u1, SS, MF)
    ref_dots = tpcg.fused_dots([(r1, u1), (w1, u1), (r1, r1)])
    for name, out, ref in zip(NAMES, ours, (x1, r1, u1, w1, p1, s1)):
        _close(out.numpy(), ref.numpy(), 1e-6, name)
    for got, ref in zip(dots, ref_dots):
        assert float(got) == pytest.approx(float(ref), rel=1e-6)
    # the CUDA kernels' class-table arithmetic on the same u'
    _close(ours[3].numpy(), emulate_keff(tm, ours[2].numpy(), SS, MF), 1e-5, "w")
    # constrained components: p' = s' = 0, u' = +0.0 and w' = u'
    for v in (ours[2], ours[4], ours[5], ours[3]):
        vb = v[bc]
        assert not vb.any() and not torch.signbit(vb).any()

    # the wrapper on CPU tensors is the plain version (no launch)
    before = k6.pcg_iteration_fused.launches
    wrapped, wdots = k6.pcg_iteration_fused(
        tm, pc.table, tuple(torch.from_numpy(c) for c in carries),
        torch.tensor(ALPHA), torch.tensor(BETA), SS, MF,
    )
    assert k6.pcg_iteration_fused.launches == before
    for a, b in zip(wrapped, ours):
        assert torch.equal(a, b)
    assert torch.equal(torch.stack(wdots), torch.stack(dots))


def _cantilever_problem(dims):
    jm, jf, tm, _ = build_pair(
        dims, dict(fixed_axis_planes=("x0",), traction=(0.0, 0.0, -1.0e6))
    )
    rhs = np.array(jnp.where(jm.bc_mask, jm.bc_value, jf), np.float32)
    return jm, tm, rhs


def _spy_route(monkeypatch):
    """Count bundle builds and iteration calls; fail if the split loop's
    K2-with-dots path is entered."""
    calls = {"built": 0, "iterations": 0}
    real = tops.build_fused_pcg_iteration

    def build(*args, **kwargs):
        iteration = real(*args, **kwargs)
        if iteration is None:
            return None
        calls["built"] += 1

        def counted(*a):
            calls["iterations"] += 1
            return iteration(*a)

        return counted

    def no_dots(*args, **kwargs):
        raise AssertionError("the split fused loop's K2-with-dots path ran")

    monkeypatch.setattr(tops, "build_fused_pcg_iteration", build)
    monkeypatch.setattr(tops, "apply_pc_keff_dots_structured", no_dots)
    return calls


@pytest.mark.parametrize(
    "dims, ss, mf, tol, max_it",
    [((5, 4, 3), np.float32(1.0), np.float32(4.0e6), 1e-8, 500),
     ((8, 6, 5), SS, MF, 2e-4, 200)],
    ids=["5x4x3_tol1e-8", "8x6x5_tol2e-4"],
)
def test_megafused_loop_matches_reference(monkeypatch, dims, ss, mf, tol, max_it):
    monkeypatch.delenv("CIVIWAVE_MEGA_PCG", raising=False)
    jm, tm, rhs = _cantilever_problem(dims)
    x0 = np.zeros(jm.vector_shape, np.float32)
    x_ref, tel_ref = jpcg.solve_pcg_fused(
        jm, jnp.asarray(rhs), ss, mf, tol, max_it, jnp.asarray(x0),
        warm_start=False, preconditioner=jm.build_preconditioner(ss, mf),
    )
    x_ref = np.asarray(x_ref)

    monkeypatch.setenv("CIVIWAVE_MEGA_PCG", "1")
    calls = _spy_route(monkeypatch)
    x, tel = tpcg.solve_pcg_fused(
        tm, torch.from_numpy(rhs), ss, mf, tol, max_it, torch.from_numpy(x0),
        warm_start=False,
    )
    assert calls["built"] == 1 and calls["iterations"] == tel.iterations
    assert tel.converged == bool(tel_ref.converged) is True
    assert tel.breakdown == bool(tel_ref.breakdown) is False
    assert abs(tel.iterations - int(tel_ref.iterations)) <= 1
    assert tel.iterations > 3
    _close(x.numpy(), x_ref, VEC_TOL, "x")
    bc = tm.bc_mask.numpy()
    np.testing.assert_array_equal(x.numpy()[bc], rhs[bc])
    assert float(tel.rhs_norm) == pytest.approx(float(tel_ref.rhs_norm), rel=1e-6)
    assert float(tel.residual_norm) <= tol * float(tel.rhs_norm)
    if tol < 1e-6:
        # the last steps at 1e-8 are taken at the f32 rounding floor, where
        # the step scalars are rounding noise (~10 % apart between the two
        # packages' split loops too); they are held at run-time tolerance
        return
    for field in ("alpha_last", "beta_last"):
        assert float(getattr(tel, field)) == pytest.approx(
            float(getattr(tel_ref, field)), rel=0.05
        ), field


def test_stepping_matches_reference_fused_stepper(monkeypatch):
    monkeypatch.delenv("CIVIWAVE_MEGA_PCG", raising=False)
    node = dict(mesh={"path": "synthetic://box/12,12,12"})
    jcfg = jcantilever_config(tol_runtime=2e-4, max_iters=120, **node)
    jm, jsched = jtry_build(jcfg)
    jforce = jsched.at_time(jcfg.curves, 0.0)
    ref = JNewmarkStepper(
        jm, jm.zero_state(), jforce, jmaterials.compute_rayleigh(jcfg.damping),
        jcfg.solver, jcfg.time, solver_variant="fused",
    )
    ref_tel = [ref.step(ref.accumulated_time) for _ in range(6)]

    monkeypatch.setenv("CIVIWAVE_MEGA_PCG", "1")
    calls = _spy_route(monkeypatch)
    cfg = cantilever_config(tol_runtime=2e-4, max_iters=120, **node)
    tm = to_port(jm)
    ours = NewmarkStepper(
        tm, tm.zero_state(), torch.as_tensor(np.asarray(jforce)),
        materials.compute_rayleigh(cfg.damping), cfg.solver, cfg.time,
        solver_variant="fused",
    )
    tel = [ours.step(ours.accumulated_time) for _ in range(6)]
    assert calls["built"] == 6
    assert calls["iterations"] == sum(t.pcg_iterations for t in tel)
    iters = [t.pcg_iterations for t in tel]
    ref_iters = [t.pcg_iterations for t in ref_tel]
    assert all(abs(a - b) <= 1 for a, b in zip(iters, ref_iters)), (iters, ref_iters)
    assert all(t.pcg_converged for t in tel)
    for name, tol in (("displacement", 2.5e-4), ("acceleration", 3e-3)):
        refv = np.asarray(getattr(ref.state, name))
        _close(getattr(ours.state, name).numpy(), refv, tol, name)


def test_build_simulation_reaches_the_megafused_loop(monkeypatch):
    """The structured route of build_simulation on the fused variant takes
    the whole-iteration loop once per frame when the switch is set."""
    monkeypatch.setenv("CIVIWAVE_MEGA_PCG", "1")
    calls = _spy_route(monkeypatch)
    cfg = cantilever_config(tol_runtime=2e-4, max_iters=120,
                            mesh={"path": "synthetic://box/6,3,3"})
    sim = build_simulation(cfg, device="cpu")
    sim.stepper.solver_variant = "fused"
    tel = sim.run(3)
    assert all(t.pcg_converged for t in tel)
    assert calls["built"] == 3
    assert calls["iterations"] == sum(t.pcg_iterations for t in tel) > 0


def test_gating(monkeypatch):
    _, _, tm, _ = build_pair((5, 4, 3), dict(fixed_axis_planes=("x0",)))
    pc = tm.build_preconditioner(SS, MF)
    f32, f64 = torch.float32, torch.float64
    for value in (None, "0", "true"):
        if value is None:
            monkeypatch.delenv("CIVIWAVE_MEGA_PCG", raising=False)
        else:
            monkeypatch.setenv("CIVIWAVE_MEGA_PCG", value)
        assert tm.build_fused_pcg_iteration(pc, SS, MF, f64, f32) is None
    monkeypatch.setenv("CIVIWAVE_MEGA_PCG", "1")
    assert callable(tm.build_fused_pcg_iteration(pc, SS, MF, f64, f32))
    # fp64 vectors and a non-class-table preconditioner are refused
    assert tm.build_fused_pcg_iteration(pc, SS, MF, f64, f64) is None
    assert tm.build_fused_pcg_iteration(pc.table, SS, MF, f64, f32) is None


def test_switch_off_runs_the_split_loop(monkeypatch):
    monkeypatch.delenv("CIVIWAVE_MEGA_PCG", raising=False)
    _, tm, rhs = _cantilever_problem((5, 4, 3))
    seen = []
    real = tops.apply_pc_keff_dots_structured

    def dots(*args, **kwargs):
        seen.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tops, "apply_pc_keff_dots_structured", dots)
    _, tel = tpcg.solve_pcg_fused(
        tm, torch.from_numpy(rhs), SS, MF, 2e-4, 200,
        torch.zeros(tm.vector_shape), warm_start=False,
    )
    assert tel.converged and len(seen) == tel.iterations > 3


# the folded loop's answers on the warm-started 6x5x4 problem below, as
# both the split Chronopoulos-Gear loop and the separate whole-iteration
# loop gave them before the two became bodies of one loop (bit-equal to
# each other on the CPU)
FOLDED_ITERATIONS = 38
FOLDED_SAMPLES = {(2, 5, 2, 3): -1.2275832887098659e-05,
                  (0, 3, 1, 1): -2.152868773919181e-06,
                  (1, 6, 4, 4): -3.396136207811651e-07}


def test_folded_loop_runs_either_body(monkeypatch):
    """``solve_pcg_fused`` with and without ``CIVIWAVE_MEGA_PCG=1`` on one
    warm-started problem: each body runs once per iteration, both give
    the same x bit for bit, the iteration count and x the loops gave
    before they were folded, and the reference's split loop's answer."""
    jm, tm, rhs = _cantilever_problem((6, 5, 4))
    x0 = (1e-7 * np.random.default_rng(3).standard_normal(jm.vector_shape)
          ).astype(np.float32)
    x_ref, tel_ref = jpcg.solve_pcg_fused(
        jm, jnp.asarray(rhs), SS, MF, 1e-6, 300, jnp.asarray(x0),
        preconditioner=jm.build_preconditioner(SS, MF),
    )
    dots = []
    real_dots = tops.apply_pc_keff_dots_structured

    def counted_dots(*args, **kwargs):
        dots.append(1)
        return real_dots(*args, **kwargs)

    outs = {}
    for mega in ("0", "1"):
        monkeypatch.setenv("CIVIWAVE_MEGA_PCG", mega)
        if mega == "1":
            calls = _spy_route(monkeypatch)
        else:
            monkeypatch.setattr(tops, "apply_pc_keff_dots_structured", counted_dots)
        x, tel = tpcg.solve_pcg_fused(
            tm, torch.from_numpy(rhs), SS, MF, 1e-6, 300,
            torch.from_numpy(x0).clone(),
        )
        assert (tel.iterations, tel.converged, tel.breakdown) == (
            FOLDED_ITERATIONS, True, False), mega
        assert abs(tel.iterations - int(tel_ref.iterations)) <= 1
        for index, value in FOLDED_SAMPLES.items():
            assert float(x[index]) == pytest.approx(value, rel=1e-6), index
        _close(x.numpy(), np.asarray(x_ref), VEC_TOL, "x")
        outs[mega] = x, tel
    assert len(dots) == FOLDED_ITERATIONS
    assert calls["built"] == 1 and calls["iterations"] == FOLDED_ITERATIONS
    (xs, ts), (xk, tk) = outs["0"], outs["1"]
    assert torch.equal(xs, xk)
    for field in ("residual_norm", "rhs_norm", "alpha_last", "beta_last"):
        assert torch.equal(getattr(ts, field), getattr(tk, field)), field


def test_general_path_has_no_hook(monkeypatch):
    """PackedModel builds no bundle: with the switch set the general path
    still runs its split loop."""
    monkeypatch.setenv("CIVIWAVE_MEGA_PCG", "1")
    cfg = cantilever_config(tol_runtime=2e-4, max_iters=200,
                            mesh={"path": "synthetic://box/3,2,2,tet"})
    sim = build_simulation(cfg, device="cpu")
    assert isinstance(sim.model, PackedModel)
    assert not hasattr(sim.model, "build_fused_pcg_iteration")
    sim.stepper.solver_variant = "fused"
    tel = sim.run(2)
    assert all(t.pcg_converged for t in tel)


def test_wrapper_refuses_other_devices():
    _, _, tm, _ = build_pair((5, 4, 3), {})
    carries = tuple(torch.zeros(tm.vector_shape, device="meta") for _ in NAMES)
    with pytest.raises(ValueError):
        k6.pcg_iteration_fused(
            tm, torch.zeros(6, 3, 3, 3), carries, 0.3, 0.2, SS, MF
        )
