"""Heterogeneous structured grids (per-cell lam/mu) in the port against the
JAX package, on the CPU.

The same per-cell materials, lam_c = lam0 (1 + U) and mu_c = mu0 (1 + U')
with U, U' uniform on [0, 1) from a numpy seed (the reference's own
heterogeneous case, ``__graft_entry__.py:218-223``), go to both packages'
``build_structured_model``:

* ``build_structured_model``: every array field and the force equal bit for bit, with
  +X pad planes and dead +Y rows; the uniform-grid detection
  (``tests/test_structured.py::test_heterogeneous_grid_selects_corner_path``)
  and the absorbing-face ValueError;
* the plain operator (G3's plain version, the corner-gather element loop)
  against the reference's heterogeneous ``apply_keff``: f32 at BASELINE's
  operator tolerance, max(1e-4, 3e-4 |ref|) per DOF, f64 at 1e-12 of
  max|ref|; a uniform grid marked heterogeneous against the homogeneous
  operator within 3e-6 of max (the bound of the reference's
  ``test_homogeneous_stencil_matches_corner_path``);
* the per-node block-Jacobi inverse and its apply against the reference's;
* Newmark frames (adaptive dt, so the preconditioner is rebuilt) against
  the reference's stepper in f32 and f64 (u within 2.5e-4 and a within
  3e-3 of max, iterations within 1), a static solve, a checkpoint resume;
* the multigrid fallback, derived fields and probes, and ``convert`` of a
  heterogeneous JAX model (its shards: ``test_torch_sharded_heterogeneous``);
* the routing: every homogeneous kernel (K1, K2, K4 + G2, K6) declines a
  heterogeneous grid and 'auto' PCG resolves to classic.

G3 itself, the CUDA kernel, is held against this plain version on the card
(``tests/test_torch_kernels_cuda.py -k corner_gather``, ``chip_smoke.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from civiwave_tpu.mesh import structured as jstructured
from civiwave_tpu.ops import multigrid as jmg
from civiwave_tpu.ops import structured as jops
from civiwave_tpu.physics import materials as jmaterials
from civiwave_tpu.post import structured_fields as jfields
from civiwave_tpu.solver.static import solve_static as jsolve_static
from civiwave_tpu.solver.stepper import NewmarkStepper as JStepper
from civiwave_tpu.utils.synthetic import cantilever_config as jcantilever_config
from civiwave_tpu_torch import convert
from civiwave_tpu_torch.mesh import structured as tstructured
from civiwave_tpu_torch.ops import multigrid as tmg
from civiwave_tpu_torch.ops import structured as tops
from civiwave_tpu_torch.ops.cuda import _build
from civiwave_tpu_torch.ops.cuda import corner_gather as g3
from civiwave_tpu_torch.physics import materials as tmaterials
from civiwave_tpu_torch.post import structured_fields as tfields
from civiwave_tpu_torch.solver.pcg import resolve_variant
from civiwave_tpu_torch.solver.static import solve_static
from civiwave_tpu_torch.solver.stepper import NewmarkStepper, effective_scalars
from civiwave_tpu_torch.utils.checkpoint import CheckpointManager
from civiwave_tpu_torch.utils.synthetic import cantilever_config

torch.set_num_threads(2)

CPU = torch.device("cpu")
SEED = 7
SS, MF = np.float32(1.0000727), np.float32(4.0003636e6)
U_TOL, A_TOL = 2.5e-4, 3e-3  # of max|ref| (BASELINE stepping tolerances)
F64_TOL = 1e-12  # of max|ref|
TRACTION = (0.0, 0.0, -1.0e6)

CASES = {
    "plain": ((6, 5, 4), {}),
    "xpad": ((6, 5, 4), dict(pad_x_multiple=4)),
    "ypad": ((5, 2, 3), dict(pad_y_multiple=4)),
    "xpad_ypad_fixes": ((7, 3, 4), dict(
        pad_x_multiple=3, pad_y_multiple=2, fixes=[
            ("x0", (True, True, True), (None, None, None)),
            ("z1", (True, False, True), (1e-3, None, -2e-3)),
        ])),
}


def steel():
    return cantilever_config().materials[0]


def cell_grids(dims, seed=SEED):
    """lam0 (1 + U), mu0 (1 + U') per cell, in f64 (both packages store
    f32), from ``default_rng(seed)``."""
    lame = tmaterials.make_properties(steel()).lame
    rng = np.random.default_rng(seed)
    return (lame.lam * (1.0 + rng.uniform(0.0, 1.0, dims)),
            lame.mu * (1.0 + rng.uniform(0.0, 1.0, dims)))


def build_pair(dims, kw, lam=None, mu=None):
    """(jax model, jax force, port model, port force) with the same cells."""
    mat = steel()
    if lam is None and mu is None:
        lam, mu = cell_grids(dims)
    kw = dict(traction=TRACTION, lam_grid=lam, mu_grid=mu, **kw)
    jm, jf = jstructured.build_structured_model(
        *dims, jmaterials.make_properties(mat), mat.density, **kw)
    tm, tf = tstructured.build_structured_model(
        *dims, tmaterials.make_properties(mat), mat.density, device=CPU, **kw)
    return jm, jf, tm, tf


def vector(model, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(model.vector_shape).astype(dtype)


def assert_close(got, ref, rel, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), f"{name}: {err:.3e}"
    return err


def to_port(jm):
    """The JAX model handed over through convert."""
    arrays = {n: np.asarray(getattr(jm, n)) for n in convert.STRUCTURED_ARRAYS}
    meta = {n: getattr(jm, n) for n in convert.STRUCTURED_META}
    return convert.structured_model_from_arrays(arrays, meta, CPU)


# --- the model ---------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_built_fields_equal_reference(case):
    dims, kw = CASES[case]
    jm, jf, tm, tf = build_pair(dims, kw)
    assert not tm.homogeneous and not jm.homogeneous
    for name, dtype in convert.STRUCTURED_ARRAYS.items():
        a, b = getattr(tm, name).numpy(), np.asarray(getattr(jm, name))
        assert a.shape == b.shape and a.dtype == b.dtype == dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    for name in convert.STRUCTURED_META:
        assert getattr(tm, name) == getattr(jm, name), name
    assert (tm.lam0, tm.mu0) == (0.0, 0.0)
    # the live cells are the given materials, rounded to f32
    lam, _ = cell_grids(dims)
    np.testing.assert_array_equal(tm.lam_cells.numpy(), lam.astype(np.float32))


def test_uniform_grids_are_detected_homogeneous():
    """The reference's test_heterogeneous_grid_selects_corner_path on the
    port: one changed cell makes the grid heterogeneous, explicit uniform
    grids are homogeneous with their value as lam0/mu0."""
    dims = (4, 3, 2)
    lame = tmaterials.make_properties(steel()).lame
    lam = np.full(dims, lame.lam, np.float32)
    mu = np.full(dims, lame.mu, np.float32)
    one = lam.copy()
    one[0, 0, 0] *= 2.0
    jm, _, tm, _ = build_pair(dims, {}, one, mu)
    assert not tm.homogeneous and not jm.homogeneous
    for lam_g, mu_g in ((lam, mu), (lam * 1.5, mu * 0.5), (lam, None)):
        jm, _, tm, _ = build_pair(dims, {}, lam_g, mu_g)
        assert tm.homogeneous and jm.homogeneous
        assert (tm.lam0, tm.mu0) == (jm.lam0, jm.mu0)
        assert float(np.float32(tm.lam0)) == float(lam_g.flat[0])
        np.testing.assert_array_equal(tm.stencil_table.numpy(),
                                      tops.class_stencil_table(
                                          tm.spacing, jm.lam0, jm.mu0))


def test_absorbing_faces_on_a_heterogeneous_grid_raise():
    dims = (4, 3, 2)
    lam, mu = cell_grids(dims)
    mat = steel()
    errors = []
    for build, props, extra in (
        (jstructured.build_structured_model, jmaterials.make_properties(mat), {}),
        (tstructured.build_structured_model, tmaterials.make_properties(mat),
         dict(device=CPU)),
    ):
        with pytest.raises(ValueError) as info:
            build(*dims, props, mat.density, lam_grid=lam, mu_grid=mu,
                  absorb_planes=("z0",), **extra)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert "homogeneous" in errors[1]


# --- the operator ------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "xpad", "ypad", "xpad_ypad_fixes"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_plain_operator_matches_reference(case, dtype):
    dims, kw = CASES[case]
    jm, _, tm, _ = build_pair(dims, kw)
    x = vector(tm, seed=11, dtype=dtype)
    ss, mf = (SS, MF) if dtype == np.float32 else (np.float64(SS), np.float64(MF))
    ref = np.asarray(jm.apply_keff(jnp.asarray(x), ss, mf))
    got = tm.apply_keff(torch.as_tensor(x), ss, mf)
    assert got.dtype == torch.from_numpy(x).dtype
    got = got.numpy()
    if dtype == np.float32:
        # BASELINE's operator tolerance, per DOF
        np.testing.assert_allclose(got, ref, rtol=3e-4, atol=1e-4)
    else:
        assert_close(got, ref, F64_TOL)
    bc = tm.bc_mask.numpy()
    np.testing.assert_array_equal(got[bc], x[bc])
    # G3's wrapper takes the same plain version on the CPU
    np.testing.assert_array_equal(
        g3.apply_keff_corner_gather(tm, torch.as_tensor(x), ss, mf).numpy(), got)


def test_uniform_grid_marked_heterogeneous_matches_stencil():
    """The corner gather on a uniform grid equals the constant-stencil
    operator within 3e-6 of max (tests/test_structured.py's bound)."""
    dims, kw = CASES["xpad_ypad_fixes"]
    mat = steel()
    tm, _ = tstructured.build_structured_model(
        *dims, tmaterials.make_properties(mat), mat.density, device=CPU, **kw)
    hetero = dataclasses.replace(tm, homogeneous=False)
    x = torch.as_tensor(vector(tm, seed=12))
    fast = tm.apply_keff(x, SS, MF)
    gather = hetero.apply_keff(x, SS, MF)
    assert_close(fast, gather, 3e-6)


def test_pair_tables_reproduce_the_corner_gather_in_f64():
    """G3's split element matrix lam A + mu B (the tables its kernel reads)
    applied cell by cell in numpy equals the plain corner gather at 1e-12
    of max|ref|: the kernel's arithmetic, emulated on the CPU."""
    dims, kw = CASES["xpad_ypad_fixes"]
    _, _, tm, _ = build_pair(dims, kw)
    x = vector(tm, seed=13, dtype=np.float64)
    tables = g3.pair_tables(tm.spacing, torch.float64)
    assert tables.shape == (2, 8, 3, 8, 3)
    assert g3.pair_tables(tm.spacing, torch.float32).dtype == np.float32
    bc = tm.bc_mask.numpy()
    xs = np.where(bc, 0.0, x)
    nx, ny, nz = tm.nx, tm.ny, tm.nz
    lam = tm.lam_cells.numpy().astype(np.float64)
    mu = tm.mu_cells.numpy().astype(np.float64)
    stiff = np.zeros_like(x)
    for l, (di, dj, dk) in enumerate(tstructured.CORNERS):
        for m, (ei, ej, ek) in enumerate(tstructured.CORNERS):
            u = xs[:, ei:ei + nx, ej:ej + ny, ek:ek + nz]
            stiff[:, di:di + nx, dj:dj + ny, dk:dk + nz] += (
                np.einsum("bc,cxyz->bxyz", tables[0, l, :, m], u) * lam
                + np.einsum("bc,cxyz->bxyz", tables[1, l, :, m], u) * mu)
    ss, mf = np.float64(SS), np.float64(MF)
    emulated = np.where(bc, x, ss * stiff + mf * tm.mass_grid.numpy() * xs)
    plain = tops.apply_keff_structured_plain(tm, torch.as_tensor(x), ss, mf)
    assert_close(emulated, plain.numpy(), F64_TOL)


def test_homogeneous_kernels_decline_a_heterogeneous_grid(monkeypatch):
    """K4 + G2 (slender route), K2 (fused pc+matvec, its dots) and K6
    (megafused) decline; K1/K5 and K2 raise if reached; 'auto' is
    classic.  The homogeneous twin of the same grid takes each."""
    dims, kw = CASES["plain"]
    _, _, tm, _ = build_pair(dims, kw)
    mat = steel()
    homo, _ = tstructured.build_structured_model(
        *dims, tmaterials.make_properties(mat), mat.density, device=CPU, **kw)
    # with every grid slender by shape, the heterogeneous one still takes
    # the corner gather (the split form's taps hold one material)
    monkeypatch.setattr(tops, "_FLAT_INTERIOR_NODE_THRESHOLD", 0)
    assert tops.slender_route(homo, torch.float32)
    x = torch.as_tensor(vector(tm, seed=18))
    torch.testing.assert_close(
        tm.apply_keff(x, SS, MF),
        tops.apply_keff_structured_plain(tm, x, SS, MF), rtol=0, atol=0)
    monkeypatch.setattr(tops, "_FLAT_INTERIOR_NODE_THRESHOLD", 700_000)
    pc = tm.build_preconditioner(SS, MF)
    assert isinstance(pc, torch.Tensor) and pc.shape == (6, *tm.grid_shape)
    homo_pc = homo.build_preconditioner(SS, MF)
    assert isinstance(homo_pc, tops.CompactBlockJacobi)
    r = torch.as_tensor(vector(tm, seed=14))
    assert not tops.pc_keff_kernel_eligible(tm, pc, torch.float32)
    assert tm.apply_pc_keff_dots(pc, r, SS, MF, torch.float64) is None
    assert not tm.prefers_fused_pcg(pc, torch.float32)
    assert resolve_variant(tm, "auto", pc, torch.float32) == "classic"
    monkeypatch.setenv("CIVIWAVE_MEGA_PCG", "1")
    assert tm.build_fused_pcg_iteration(pc, SS, MF, torch.float64,
                                        torch.float32) is None
    assert homo.build_fused_pcg_iteration(homo_pc, SS, MF, torch.float64,
                                          torch.float32) is not None
    with pytest.raises(ValueError, match="corner_gather"):
        _build.check_homogeneous(tm, "keff_structured")
    _build.check_homogeneous(homo, "keff_structured")
    # (u, w) composes the per-node apply and the corner gather
    u, w = tm.apply_pc_keff(pc, r, SS, MF)
    torch.testing.assert_close(u, tops.apply_preconditioner_structured(tm, pc, r),
                               rtol=0, atol=0)
    torch.testing.assert_close(w, tm.apply_keff(u, SS, MF), rtol=0, atol=0)


# --- the preconditioner ----------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "xpad_ypad_fixes"])
def test_per_node_inverse_matches_reference(case):
    dims, kw = CASES[case]
    jm, _, tm, _ = build_pair(dims, kw)
    ref = np.asarray(jm.build_preconditioner(SS, MF))
    want = np.asarray(jops.build_block_jacobi_inverse_structured(jm, SS, MF))
    np.testing.assert_array_equal(ref, want)
    got = tm.build_preconditioner(SS, MF)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    for comp in range(6):  # each packed component against its own scale
        assert_close(got[comp].numpy(), ref[comp], 1e-6, f"component {comp}")
    r = vector(tm, seed=15)
    z_ref = np.asarray(jm.apply_preconditioner(jnp.asarray(ref), jnp.asarray(r)))
    z = tm.apply_preconditioner(got, torch.as_tensor(r)).numpy()
    assert_close(z, z_ref, 1e-6)
    assert not z[tm.bc_mask.numpy()].any()


# --- stepping and static solves ----------------------------------------------

STEP_DIMS = (10, 3, 3)
STEP_FRAMES = 3


def steppers(precision):
    """The port's and the reference's NewmarkStepper on the same
    heterogeneous cantilever, adaptive dt (iterations under 0.3 of the cap
    grow dt, so the per-node inverse is rebuilt every frame)."""
    jm, jf, tm, tf = build_pair(STEP_DIMS, {})
    extra = dict(tol_runtime=2e-4, max_iters=120, adaptive=True)
    tcfg, jcfg = cantilever_config(**extra), jcantilever_config(**extra)
    ray = tmaterials.compute_rayleigh(tcfg.damping)
    jray = jmaterials.compute_rayleigh(jcfg.damping)
    port = NewmarkStepper(tm, tm.zero_state(), tf, ray, tcfg.solver, tcfg.time,
                          vector_precision=precision)
    ref = JStepper(jm, jm.zero_state(), jf, jray, jcfg.solver, jcfg.time,
                   vector_precision=precision)
    return port, ref


def run(stepper, frames):
    tel = []
    for _ in range(frames):
        tel.append(stepper.step(stepper.accumulated_time))
    return tel


@pytest.mark.parametrize("precision", ["fp32", "fp64"])
def test_newmark_frames_match_reference(precision):
    port, ref = steppers(precision)
    tel, jtel = run(port, STEP_FRAMES), run(ref, STEP_FRAMES)
    assert port.pcg_variant() == "classic"
    assert isinstance(port._precond, torch.Tensor)
    assert all(t.pcg_converged for t in tel)
    assert [t.time_step for t in tel] == [t.time_step for t in jtel]
    assert len({t.time_step for t in tel}) > 1  # dt changed: pc rebuilt
    for a, b in zip(tel, jtel):
        assert abs(a.pcg_iterations - b.pcg_iterations) <= 1
    dtype = torch.float64 if precision == "fp64" else torch.float32
    assert port.state.displacement.dtype == dtype
    state, jstate = port.state, ref.state
    assert_close(state.displacement.numpy(), np.asarray(jstate.displacement),
                 U_TOL, "u")
    assert_close(state.acceleration.numpy(), np.asarray(jstate.acceleration),
                 A_TOL, "a")
    assert float(state.displacement[2, STEP_DIMS[0]].min()) < 0.0


def test_static_solve_matches_reference():
    """solve_static (per-node inverse at (ss, mf) = (1, 0), cold start)
    against the reference's, op by op, at 1e-6: on the f32 residual's
    plateau near 1e-8 the stop moves with the rounding (129 to 138
    iterations between the reference's own op-by-op and jitted loops)."""
    jm, jf, tm, tf = build_pair(STEP_DIMS, {})
    u, tel = solve_static(tm, tf, tolerance=1e-6, max_iterations=2000)
    ju, jtel = jsolve_static(jm, jf, tolerance=1e-6, max_iterations=2000)
    assert tel.converged and bool(jtel.converged)
    assert abs(tel.iterations - int(jtel.iterations)) <= 1
    assert_close(u.numpy(), np.asarray(ju), U_TOL, "static u")


def test_checkpoint_resume_is_bit_equal(tmp_path):
    """2 frames, a checkpoint, 2 more; a fresh stepper restores the
    checkpoint (the per-node inverse rebuilt at the restored dt) and runs
    the same 2 frames bit for bit."""
    port, _ = steppers("fp32")
    run(port, 2)
    manager = CheckpointManager(str(tmp_path), max_to_keep=1)
    port.save_checkpoint(manager, wait=True)
    run(port, 2)
    fresh, _ = steppers("fp32")
    assert fresh.restore_checkpoint(manager) == 2
    run(fresh, 2)
    for name in ("displacement", "velocity", "acceleration", "warm_x"):
        assert torch.equal(getattr(fresh.state, name), getattr(port.state, name))
    assert fresh.current_dt == port.current_dt


# --- multigrid, post-processing, convert, shards ----------------------------


def test_multigrid_falls_back_on_a_heterogeneous_grid(capsys):
    jm, _, tm, _ = build_pair((4, 4, 4), {})
    assert jmg.attach_multigrid(jm) is jm
    ref_note = capsys.readouterr().err
    assert tmg.attach_multigrid(tm) is tm
    note = capsys.readouterr().err
    assert note == ref_note
    assert "heterogeneous material grid" in note and "block_jacobi" in note
    assert tm.preconditioner == "block_jacobi" and not tm.multigrid


def test_derived_fields_and_probes_match_reference():
    jm, _, tm, _ = build_pair(*CASES["xpad"])
    u = torch.as_tensor(vector(tm, seed=16) * 1e-3)
    got = tfields.compute_structured_derived(tm, u)
    ref = jfields.compute_structured_derived(jm, jnp.asarray(u.numpy()))
    for index, (a, b) in enumerate(zip(got, ref)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, index
        np.testing.assert_allclose(a.numpy(), b, rtol=0.0,
                                   atol=1e-6 * np.abs(b).max(), err_msg=index)
    probes = (0, 7, 33, 59, tm.node_count - 1)
    state = tm.zero_state().__class__(u, u * 2, u * 3, u)
    kin, windows = tfields.probe_samples(tm, state, probes)
    jstate = jm.zero_state().__class__(*(
        jnp.asarray(t.numpy()) for t in (u, u * 2, u * 3, u)))
    _, jwindows = jfields.probe_samples(jm, jstate, probes)
    rows = tfields.probe_derived_host(tm, probes, windows)
    for got_row, ref_row in zip(
            rows, jfields.probe_derived_host(jm, probes, jwindows)):
        np.testing.assert_array_equal(got_row[0], ref_row[0])
        np.testing.assert_array_equal(got_row[1], ref_row[1])
        assert got_row[2] == ref_row[2]
    # a probe reads its own cells: the homogeneous grid's stress differs
    mat = steel()
    homo, _ = tstructured.build_structured_model(
        *CASES["xpad"][0], tmaterials.make_properties(mat), mat.density,
        device=CPU, **CASES["xpad"][1])
    homo_rows = tfields.probe_derived_host(homo, probes, windows)
    assert not np.array_equal(homo_rows[2][1], rows[2][1])


def test_convert_carries_a_heterogeneous_model():
    jm, _, tm, _ = build_pair(*CASES["xpad_ypad_fixes"])
    carried = to_port(jm)
    assert not carried.homogeneous and (carried.lam0, carried.mu0) == (0.0, 0.0)
    for name in convert.STRUCTURED_ARRAYS:
        assert torch.equal(getattr(carried, name), getattr(tm, name)), name
    x = torch.as_tensor(vector(tm, seed=17))
    torch.testing.assert_close(carried.apply_keff(x, SS, MF),
                               tm.apply_keff(x, SS, MF), rtol=0, atol=0)
    assert isinstance(carried.build_preconditioner(SS, MF), torch.Tensor)


def test_effective_scalars_build_the_same_inverse_as_the_stepper():
    """The stepper's hoisted preconditioner at a dt is the model's
    per-node inverse at effective_scalars(dt): a rebuild on a dt change
    takes the new scalars."""
    port, _ = steppers("fp32")
    run(port, 2)
    ss, mf = effective_scalars(port._precond_dt, port.rayleigh.alpha,
                               port.rayleigh.beta)
    assert torch.equal(port._precond, port.model.build_preconditioner(ss, mf))
