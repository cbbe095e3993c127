"""The Newmark stepper's three vector passes (``ops/cuda/newmark_vectors``)
against the torch composition they replaced, on the CPU, and without jax.

* each pass's plain version gives the bits of the composition that
  ``solver/stepper.newmark_step`` ran before the passes, kept below: the
  structured grid's (3, X, Y, Z) vectors with a (1, X, Y, Z) mass (planes of
  4 k nodes and of an odd count) and the general path's (N, 3) rows with an
  (N, 1) mass, f32 and f64, beta_R zero and not, with and without an
  absorbing term, and the "delta" policy's correction;
* ``newmark_step`` on small structured grids and small tet meshes (fp32
  and fp64, every warm-start policy, absorbing faces, beta_R = 0) gives the state bits and the PCG iterations of a copy of the old
  ``newmark_step``, frame after frame;
* the wrappers refuse a mass shape they do not know, views that are not
  contiguous, and mixed dtypes; they take views at any offset.

The kernels themselves are held to the plain versions on the card by
``tests/test_torch_kernels_cuda.py``.

    python -m pytest -q tests/test_torch_newmark_vectors.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from civiwave_tpu_torch.mesh.pack import SimState
from civiwave_tpu_torch.ops.cuda import newmark_vectors as nv
from civiwave_tpu_torch.physics import materials
from civiwave_tpu_torch.runner import build_simulation
from civiwave_tpu_torch.solver.pcg import solve_pcg
from civiwave_tpu_torch.solver.stepper import effective_scalars, newmark_step
from civiwave_tpu_torch.utils.profiling import scope
from civiwave_tpu_torch.utils.synthetic import cantilever_config

torch.set_num_threads(2)

DT, BETA, GAMMA = 1.0e-3, 0.25, 0.5
# the cantilever's Rayleigh pair (xi 0.02 at 10 and 100 rad/s)
ALPHA_R, BETA_R = 0.36363636363636365, 3.6363636363636364e-4
# vectors of each layout: planes of 4 k nodes, of an odd count, and node
# rows of N % 4 != 0
LAYOUTS = {"grid": (3, 4, 5, 6), "grid_odd": (3, 3, 5, 7), "rows": (37, 3)}


def _old_newmark_step(model, state, external_force, dt, tolerance,
                      max_iterations, *, rayleigh_alpha, rayleigh_beta,
                      newmark_beta=0.25, newmark_gamma=0.5, warm_start=True,
                      warm_start_policy="predictor", solver_variant="auto",
                      solver_replace_every=10, reduction_precision="fp64",
                      vector_precision="fp32", preconditioner=None):
    """``solver.stepper.newmark_step`` as it was before its vector work
    moved into three passes: the torch composition, op by op."""
    vdt = torch.float64 if vector_precision == "fp64" else torch.float32
    sc = np.float64 if vector_precision == "fp64" else np.float32
    dt = float(dt)
    if state.displacement.dtype != vdt:
        state = SimState(*(v.to(vdt) for v in (
            state.displacement, state.velocity, state.acceleration,
            state.warm_x)))
    external_force = external_force.to(vdt)
    beta, gamma = newmark_beta, newmark_gamma
    a0 = 1.0 / (beta * dt * dt)
    a1 = gamma / (beta * dt)
    a2 = 1.0 / (beta * dt)
    a3 = (1.0 / (2.0 * beta)) - 1.0
    a4 = (gamma / beta) - 1.0
    a5 = dt * ((gamma / (2.0 * beta)) - 1.0)
    stiffness_scale = sc(1.0 + a1 * rayleigh_beta)
    mass_factor = sc(a0 + a1 * rayleigh_alpha)

    def s(value) -> float:
        return float(sc(value))

    u, v, acc = state.displacement, state.velocity, state.acceleration
    u_pred = u + s(dt) * v + s((0.5 - beta) * dt * dt) * acc
    v_pred = v + s((1.0 - gamma) * dt) * acc
    mass = model.mass_b
    mass_term = mass * (s(a0) * u + s(a2) * v + s(a3) * acc)
    damping_rhs = s(a1) * u + s(a4) * v + s(a5) * acc
    rhs = external_force + mass_term + s(rayleigh_alpha) * mass * damping_rhs
    if rayleigh_beta != 0.0:
        damping_output = model.apply_keff(damping_rhs, sc(1.0), sc(0.0))
        rhs = rhs + s(rayleigh_beta) * damping_output
    if getattr(model, "absorb_faces", ()) or getattr(model, "has_damping", False):
        rhs = rhs + model.absorbing_force(damping_rhs)
        model = dataclasses.replace(model, damp_factor=s(a1))
    rhs = torch.where(model.bc_mask, model.bc_value.to(vdt), rhs)
    if warm_start_policy == "delta":
        x_seed = u_pred + state.warm_x
    elif warm_start_policy == "predictor":
        x_seed = u_pred
    else:
        x_seed = state.warm_x
    with scope("pcg_solve"):
        solution, tel = solve_pcg(
            model, rhs, stiffness_scale, mass_factor, tolerance, max_iterations,
            x_seed, warm_start=warm_start,
            reduction_dtype=(torch.float32 if reduction_precision == "fp32"
                             else torch.float64),
            vector_dtype=vdt, preconditioner=preconditioner,
            variant=solver_variant, replace_every=solver_replace_every)
    delta = solution - u_pred
    new_state = SimState(
        displacement=u_pred + delta,
        velocity=v_pred + s(gamma / (beta * dt)) * delta,
        acceleration=s(1.0 / (beta * dt * dt)) * delta,
        warm_x=delta if warm_start_policy == "delta" else solution)
    return new_state, tel


def _scalars(beta_r=BETA_R, dt=DT):
    return nv.NewmarkScalars(
        dt=dt, c_pred=(0.5 - BETA) * dt * dt, a0=1.0 / (BETA * dt * dt),
        a2=1.0 / (BETA * dt), a3=(1.0 / (2.0 * BETA)) - 1.0,
        a1=GAMMA / (BETA * dt), a4=(GAMMA / BETA) - 1.0,
        a5=dt * ((GAMMA / (2.0 * BETA)) - 1.0), alpha_r=ALPHA_R, beta_r=beta_r,
        c_vpred=(1.0 - GAMMA) * dt, c_v=GAMMA / (BETA * dt),
        c_a=1.0 / (BETA * dt * dt))


def _mass_shape(shape):
    return (1, *shape[1:]) if len(shape) == 4 else (shape[0], 1)


def _inputs(layout, dtype, seed=3):
    """u, v, a, f, x (a solution), Kd, C d of ``dtype``; the f32 mass,
    mask and bc_value."""
    shape = LAYOUTS[layout]
    g = torch.Generator().manual_seed(seed)

    def vec(scale):
        return (scale * torch.randn(shape, generator=g, dtype=torch.float64)).to(dtype)

    u, v, a, f, x, kd, cd = (vec(s) for s in (1e-4, 1e-2, 10.0, 1e5, 1e-4, 1e7, 1e3))
    mass = (1.0 + torch.rand(_mass_shape(shape), generator=g)) * 7800.0
    bc = torch.rand(shape, generator=g) < 0.3
    bc_value = torch.where(torch.rand(shape, generator=g) < 0.5, 0.0,
                           1e-3 * torch.randn(shape, generator=g)).float()
    return u, v, a, f, x, kd, cd, mass, bc, bc_value


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("policy", ["predictor", "delta"])
@pytest.mark.parametrize("absorbing", [False, True], ids=["no_absorbing", "absorbing"])
@pytest.mark.parametrize("beta_r", [BETA_R, 0.0], ids=["beta_r", "beta_r0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_passes_give_the_old_composition_bits(layout, dtype, beta_r,
                                                    absorbing, policy):
    u, v, a, f, x, kd, cd, mass, bc, bc_value = _inputs(layout, dtype)
    sc = np.float64 if dtype == torch.float64 else np.float32

    def s(value):
        return float(sc(value))

    k = _scalars(beta_r)
    # the old composition, expression for expression
    u_pred = u + s(k.dt) * v + s((0.5 - BETA) * DT * DT) * a
    v_pred = v + s((1.0 - GAMMA) * DT) * a
    mass_term = mass * (s(k.a0) * u + s(k.a2) * v + s(k.a3) * a)
    damping_rhs = s(k.a1) * u + s(k.a4) * v + s(k.a5) * a
    rhs = f + mass_term + s(ALPHA_R) * mass * damping_rhs
    if beta_r != 0.0:
        rhs = rhs + s(beta_r) * kd
    if absorbing:
        rhs = rhs + cd
    rhs = torch.where(bc, bc_value.to(dtype), rhs)
    delta = x - u_pred
    old = (u_pred + delta, v_pred + s(GAMMA / (BETA * DT)) * delta,
           s(1.0 / (BETA * DT * DT)) * delta)

    got_pred, got_d, got_rhs = nv.newmark_rhs(mass, u, v, a, f, k)
    _same_bits(got_pred, u_pred)
    _same_bits(got_d, damping_rhs)
    got_rhs = nv.newmark_rhs_clamp(got_rhs, kd if beta_r != 0.0 else None,
                                   cd if absorbing else None, bc, bc_value, k)
    _same_bits(got_rhs, rhs)
    assert torch.equal(got_rhs[bc], bc_value[bc].to(dtype))
    got = nv.newmark_update(x, got_pred, v, a, k, write_delta=policy == "delta")
    for g, want in zip(got[:3], old):
        _same_bits(g, want)
    if policy == "delta":
        _same_bits(got[3], delta)
    else:
        assert got[3] is None


def test_alpha_m_is_rounded_to_f32_in_both_precisions():
    """The old composition's alpha_R m is an f64 scalar times the f32 mass,
    an f32 tensor even in fp64: the pass rounds it there too."""
    u, v, a, f, x, kd, cd, mass, bc, bc_value = _inputs("grid", torch.float64)
    k = _scalars()
    _, d, rhs = nv.newmark_rhs(mass, u, v, a, f, k)
    mass_term = mass * (k.a0 * u + k.a2 * v + k.a3 * a)
    widened = (f + mass_term) + (ALPHA_R * mass.double()) * d
    rounded = (f + mass_term) + (ALPHA_R * mass).double() * d
    _same_bits(rhs, rounded)
    assert not torch.equal(rhs, widened)


# small models on both routes: (mesh, extra scenario keys)
MODELS = {
    "grid_6x3x3": ("synthetic://box/6,3,3", {}),
    "grid_odd_4x2x2": ("synthetic://box/4,2,2", {}),
    "grid_absorbing": ("synthetic://box/5,3,3",
                       dict(boundaries={"absorbing": ["SIDE_X1"]})),
    # the cantilever with its Rayleigh beta_R set to 0 (no K d term)
    "grid_beta_r0": ("synthetic://box/5,3,3", {}),
    "tet_3x3x3": ("synthetic://box/3,3,3,tet", {}),
    "tet_absorbing": ("synthetic://box/3,2,2,tet",
                      dict(boundaries={"absorbing": ["SIDE_X1"]})),
}
STEP_CASES = [
    ("grid_6x3x3", "fp32", "predictor"), ("grid_6x3x3", "fp64", "delta"),
    ("grid_6x3x3", "fp32", "solution"), ("grid_odd_4x2x2", "fp32", "delta"),
    ("grid_absorbing", "fp32", "predictor"), ("grid_beta_r0", "fp32", "predictor"),
    ("tet_3x3x3", "fp32", "predictor"), ("tet_3x3x3", "fp64", "solution"),
    ("tet_absorbing", "fp32", "delta"),
]


@pytest.mark.parametrize("case,precision,policy", STEP_CASES,
                         ids=["-".join(c) for c in STEP_CASES])
def test_newmark_step_keeps_the_old_bits(case, precision, policy):
    mesh, extra = MODELS[case]
    cfg = cantilever_config(tol_runtime=2e-4, max_iters=120, dt=DT,
                            mesh={"path": mesh}, **extra)
    sim = build_simulation(cfg, device="cpu")
    model = sim.stepper.model
    assert sim.structured == case.startswith("grid")
    ray = materials.compute_rayleigh(cfg.damping)
    beta_r = 0.0 if case == "grid_beta_r0" else ray.beta
    pc = model.build_preconditioner(*effective_scalars(
        DT, ray.alpha, beta_r, vector_precision=precision))
    kwargs = dict(rayleigh_alpha=ray.alpha, rayleigh_beta=beta_r,
                  warm_start_policy=policy, vector_precision=precision,
                  preconditioner=pc)
    new = old = sim.stepper.state
    force = sim.stepper.external_force
    for frame in range(3):
        # the load grows, so each frame's solve starts from another state
        load = force * (1.0 + frame)
        out = newmark_step(model, new, load, DT, 2e-4, 120, **kwargs)
        old, old_tel = _old_newmark_step(model, old, load, DT, 2e-4, 120, **kwargs)
        new = out.state
        assert out.pcg.iterations == old_tel.iterations > 0
        for name in ("displacement", "velocity", "acceleration", "warm_x"):
            _same_bits(getattr(new, name), getattr(old, name))
    assert float(new.displacement.abs().max()) > 0.0


def _refusal_inputs():
    u, v, a, f, x, kd, cd, mass, bc, bc_value = _inputs("rows", torch.float32)
    return dict(mass=mass, u=u, v=v, a=a, f=f, k=_scalars())


def _off16(t):
    """``t``'s values in a view that starts one value past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _strided(t):
    """``t``'s values in a view that is not contiguous (every other value
    of its last dimension's buffer)."""
    return torch.cat([t, t], dim=-1)[..., ::2]


REFUSALS = {
    # a mass of the grid's shape beside node rows, a flat mass, an f64 mass
    "mass_shape": ("mass", lambda t: t.reshape(1, -1), ValueError),
    "mass_flat": ("mass", lambda t: t.reshape(-1), ValueError),
    "mass_f64": ("mass", lambda t: t.double(), TypeError),
    "strided_u": ("u", _strided, ValueError),
    "strided_mass": ("mass", _strided, ValueError),
    "mixed_dtypes": ("v", lambda t: t.double(), TypeError),
    "vector_shape": ("f", lambda t: t[:-1].contiguous(), ValueError),
    "half": ("u", lambda t: t.half(), TypeError),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_rhs_pass_refuses(case):
    args = _refusal_inputs()
    key, bad, error = REFUSALS[case]
    args[key] = bad(args[key])
    with pytest.raises(error):
        nv.newmark_rhs(**args)


def test_clamp_and_update_refuse_misaligned_and_mixed_inputs():
    """Views the kernels cannot index as dense buffers (not contiguous)
    and inputs of mixed dtypes are refused."""
    u, v, a, f, x, kd, cd, mass, bc, bc_value = _inputs("grid", torch.float32)
    k = _scalars()
    for call in (
            lambda: nv.newmark_rhs_clamp(_strided(f), kd, None, bc, bc_value, k),
            lambda: nv.newmark_rhs_clamp(f, kd.double(), None, bc, bc_value, k),
            lambda: nv.newmark_rhs_clamp(f, kd, None, bc.to(torch.uint8), bc_value, k),
            lambda: nv.newmark_rhs_clamp(f, kd, None, bc, bc_value.double(), k),
            lambda: nv.newmark_rhs_clamp(f, kd, None, _strided(bc), bc_value, k),
            lambda: nv.newmark_update(x, _strided(u), v, a, k),
            lambda: nv.newmark_update(x, u, v.double(), a, k)):
        with pytest.raises((ValueError, TypeError)):
            call()


def test_odd_planes_take_any_offset():
    """A grid whose planes hold an odd node count: a view at any offset is
    taken (the kernels read and write single values)."""
    u, v, a, f, x, kd, cd, mass, bc, bc_value = _inputs("grid_odd", torch.float32)
    k = _scalars()
    want = nv.newmark_rhs(mass, u, v, a, f, k)
    got = nv.newmark_rhs(_off16(mass), _off16(u), v, a, f, k)
    for g, w in zip(got, want):
        _same_bits(g, w)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_clamp_and_update_take_any_offset(layout):
    """Every layout: the clamp and the update take views one value past a
    16-byte boundary and give the bits of the same values held
    contiguously from the start of a buffer."""
    u, v, a, f, x, kd, cd, mass, bc, bc_value = _inputs(layout, torch.float32)
    k = _scalars()
    want = nv.newmark_rhs_clamp(f.clone(), kd, cd, bc, bc_value, k)
    got = nv.newmark_rhs_clamp(_off16(f), _off16(kd), cd, _off16(bc),
                               _off16(bc_value), k)
    _same_bits(got, want)
    want = nv.newmark_update(x, u, v, a, k, write_delta=True)
    got = nv.newmark_update(_off16(x), u, _off16(v), a, k, write_delta=True)
    for g, w in zip(got, want):
        _same_bits(g, w)
