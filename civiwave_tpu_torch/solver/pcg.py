"""Block-Jacobi PCG on device tensors, driven by a host loop.

Port of :mod:`civiwave_tpu.solver.pcg`.  The reference runs the whole solve
as one ``lax.while_loop``; here the loop is Python, every vector operation
and every reduction stays on the model's device, and the host reads the
iteration's ``converged``/``breakdown`` flags once per iteration (one
synchronisation).  The loop reproduces the reference's carry semantics
exactly: after the flags are read, the host keeps the old carries where the
reference's ``where(stop, old, new)`` / ``where(breakdown, old, new)``
would, and counts ``iteration + where(breakdown, 0, 1)``, so iteration
counts match.  (Batching k iterations per synchronisation behind CUDA
graphs is later performance work, ROADMAP A12.)

Precision contract (README.md:14, docs/spec.md:16 of the reference): FP32
vectors in the hot loop, FP64 dot-product reductions.  alpha, beta and the
dots are 0-d f64 device tensors, cast to f32 before each axpy.

Dirichlet semantics at all five touchpoints (pcg.cpp:458-475, 530-546,
674-686, 860, 903-914): sanitize input, identity rows in the operator,
x=rhs / r=0 after the initial residual, and p zeroed on constrained axes.
Degenerate denominators (|p.Ap| or |rho| < 1e-18) set ``breakdown`` and stop
the loop with converged=False.

Variants: classic, fused (Chronopoulos-Gear, one reduction per iteration;
one loop whose iteration body is U1 then K2, or with
``CIVIWAVE_MEGA_PCG=1`` one whole-iteration K6 call) and pipelined
(Ghysels-Vanroose with periodic residual replacement).  Every variant's
loop runs inside :func:`_solve`, which holds what they share: the
preconditioner, the initial residual and the telemetry.

Under a torch.profiler trace the loops open the reference's named ranges
(``pcg_matvec``, ``pcg_precondition``, ``pcg_pc_matvec``, ...;
``utils/profiling.scope``), and nothing otherwise.  Every flag read is
one ``profiling.host_syncs`` and sits in a ``pcg_host_sync`` range with
the host's branching on it; in the classic loop that range also holds the
p update the flags decide, as the nested range ``pcg_vector_update``, so
that it lasts from the sync to the device's next launch (the fused loop
runs its p/s update at the top of the next iteration, with the axpys),
and every other line of an iteration sits in a range of its own
(``pcg_dots``, ``pcg_scalars``, ``pcg_vector_update`` for the axpys): the
host's time between the device's kernels has a name.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.cuda.pcg_vector_update import cg_direction_update
from ..utils import profiling
from ..utils.profiling import scope

_BREAKDOWN_TOL = 1.0e-18
_RHS_NORM_FLOOR = 1.0e-12  # pcg.cpp:774


class PcgTelemetry(NamedTuple):
    """Solve statistics (pcg.hpp:126-133).  The flags and the iteration
    count are host values (the loop reads them anyway); the norms and step
    scalars stay 0-d device tensors in the reduction dtype."""

    iterations: int
    residual_norm: torch.Tensor
    rhs_norm: torch.Tensor
    alpha_last: torch.Tensor
    beta_last: torch.Tensor
    converged: bool
    breakdown: bool  # denominator/rho collapse


def dot_f64(a: torch.Tensor, b: torch.Tensor, dtype=torch.float64,
            psum=None):
    """High-precision reduction over f32 solver vectors — the precision
    contract.  fp64 is chunked as in the reference (pcg.cpp:170-207): the
    f32 product is partially reduced along the minor axis (Z of a
    structured (3, X, Y, Z) vector, the 3 components of an (N*, 3) nodal
    vector) in f32 and only the partials accumulate in ``dtype``.
    ``dtype=float32`` is the YAML ``precision.reductions: fp32`` opt-out.
    ``psum`` (a shard's ``model.psum``) all-reduces this rank's sum."""
    if dtype == torch.float32:
        out = (a.to(torch.float32) * b.to(torch.float32)).sum()
    else:
        prod = a * b  # f32 vectors stay f32 (chunked); f64 vectors keep f64
        if prod.ndim >= 2:
            out = prod.sum(dim=-1).to(dtype).sum()
        else:
            out = prod.to(dtype).sum()
    return out if psum is None else psum(out)


def _clamp_dirichlet(model, rhs, x, r):
    """x = rhs, r = 0 on constrained axes (pcg.cpp:458-475)."""
    x = torch.where(model.bc_mask, rhs.to(x.dtype), x)
    r = r.masked_fill(model.bc_mask, 0.0)
    return x, r


def _norm_and_tolerance(rhs2, relative_tolerance):
    """(||rhs||, the absolute stopping tolerance) from (rhs, rhs): the
    norm floored to 1 below ``_RHS_NORM_FLOOR`` (pcg.cpp:774)."""
    rhs_norm = torch.sqrt(rhs2)
    floored = torch.where(rhs_norm < _RHS_NORM_FLOOR, 1.0, rhs_norm)
    return rhs_norm, relative_tolerance * floored


def dot_partials(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 minor-axis-chunked partial products of one dot (the chunk phase
    of :func:`dot_f64` without the final accumulate)."""
    prod = a * b
    if prod.ndim >= 2:
        return prod.sum(dim=-1)
    return prod


def fused_dots(pairs, dtype=torch.float64, psum=None) -> torch.Tensor:
    """k dot products reduced in one pass: returns a (k,) tensor of the
    stacked f32 chunk partials accumulated in ``dtype``; with ``psum`` (a
    shard's ``model.psum``) this rank's k sums are all-reduced in one
    call."""
    stacked = torch.stack([dot_partials(a, b) for a, b in pairs])
    axes = tuple(range(1, stacked.ndim))
    sums = stacked.to(dtype).sum(dim=axes)
    return sums if psum is None else psum(sums)


def _flags(*conds: torch.Tensor):
    """Read boolean 0-d device tensors on the host in one transfer (a host
    sync, ``profiling.to_host``)."""
    return [bool(v) for v in profiling.to_host(torch.stack(conds)).tolist()]


def resolve_variant(model, variant: str, block_inverse, vector_dtype) -> str:
    """The PCG variant :func:`solve_pcg` runs for ``variant``: 'auto'
    becomes 'fused' where the model says it profits and 'classic'
    otherwise, as the reference (pcg.py:173-182); any other is kept."""
    if variant != "auto":
        return variant
    fused = model.prefers_fused_pcg(block_inverse, vector_dtype)
    return "fused" if fused else "classic"


def _block_inverse(model, preconditioner, stiffness_scale, mass_factor):
    """``preconditioner``, or the model's built for these scalars."""
    if preconditioner is None:
        return model.build_preconditioner(stiffness_scale, mass_factor)
    return preconditioner


def _solve(loop, model, rhs, stiffness_scale, mass_factor, relative_tolerance,
           max_iterations, x0, warm_start, reduction_dtype, vector_dtype,
           preconditioner, **options):
    """Run one variant's ``loop`` inside what every variant shares: the
    preconditioner, the initial residual (x0 or zeros, rhs - K_eff x in
    the vector dtype, Dirichlet-clamped) and the telemetry.  ``loop``
    returns x and the telemetry's fields in order."""
    block_inverse = _block_inverse(
        model, preconditioner, stiffness_scale, mass_factor
    )
    x = x0 if warm_start else torch.zeros_like(x0)
    r = (rhs - model.apply_keff(x, stiffness_scale, mass_factor)).to(vector_dtype)
    x, r = _clamp_dirichlet(model, rhs, x, r)
    x, *stats = loop(
        model, rhs, x, r, block_inverse, stiffness_scale, mass_factor,
        relative_tolerance, max_iterations, reduction_dtype, vector_dtype,
        **options,
    )
    return x, PcgTelemetry(*stats)


def solve_pcg(
    model,
    rhs: torch.Tensor,
    stiffness_scale,
    mass_factor,
    relative_tolerance,
    max_iterations,
    x0: torch.Tensor,
    warm_start: bool = True,
    reduction_dtype=torch.float64,
    vector_dtype=torch.float32,
    preconditioner=None,
    variant: str = "classic",
    replace_every: int = 10,
):
    """PCG solve; returns (solution, PcgTelemetry).

    ``preconditioner``: a prebuilt ``model.build_preconditioner(ss, mf)`` to
    reuse across solves (the stepper hoists it and rebuilds on dt changes
    only).  ``variant``: 'classic' is the reference's 3-dot loop
    (pcg.cpp:830-915); 'fused' the Chronopoulos-Gear single-reduction
    recurrence (:func:`solve_pcg_fused`); 'pipelined' the Ghysels-Vanroose
    recurrence (:func:`solve_pcg_pipelined`); 'auto' picks 'fused' where
    the model runs the fused pc+matvec+dots kernel (CUDA, f32, not under
    multigrid) and on a shard the reference marks as sharded (a structured
    shard, a general one under the halo operator: one all-reduce per
    iteration instead of two or three, as the reference's pcg.py:181-182),
    and 'classic' otherwise.  On a shard every reduction goes through
    ``model.psum``; every rank reads the same flags because the reduced
    scalars are the same.

    ``replace_every``: the pipelined variant's residual-replacement period
    (the YAML ``solver.replace_every``); 0 disables replacement.  The other
    variants ignore it.
    """
    block_inverse = _block_inverse(
        model, preconditioner, stiffness_scale, mass_factor
    )
    variant = resolve_variant(model, variant, block_inverse, vector_dtype)
    args = (model, rhs, stiffness_scale, mass_factor, relative_tolerance,
            max_iterations, x0)
    kwargs = dict(warm_start=warm_start, reduction_dtype=reduction_dtype,
                  vector_dtype=vector_dtype, preconditioner=block_inverse)
    if variant == "fused":
        return solve_pcg_fused(*args, **kwargs)
    if variant == "pipelined":
        return solve_pcg_pipelined(*args, replace_every=replace_every, **kwargs)
    if variant != "classic":
        raise ValueError(f"unknown PCG variant {variant!r}")
    return _solve(_classic_loop, *args, warm_start, reduction_dtype,
                  vector_dtype, block_inverse)


def _classic_loop(model, rhs, x, r, block_inverse, stiffness_scale,
                  mass_factor, relative_tolerance, max_iterations, rdt, f32):
    """The reference's 3-dot loop (pcg.cpp:830-915), from the clamped
    initial residual."""
    bc, psum = model.bc_mask, model.psum

    def rdot(a, b):
        return dot_f64(a, b, rdt, psum)

    rhs_norm_true, tolerance = _norm_and_tolerance(
        rdot(rhs, rhs), relative_tolerance
    )
    residual_norm = torch.sqrt(rdot(r, r))
    z = model.apply_preconditioner(block_inverse, r)
    rho = rdot(r, z)
    with scope("pcg_host_sync"):
        converged, rho_small = _flags(
            residual_norm <= tolerance, rho.abs() < _BREAKDOWN_TOL
        )
        breakdown = (not converged) and rho_small
        with scope("pcg_vector_update"):
            p = z.masked_fill(bc, 0.0).to(f32)
    alpha_last = torch.zeros((), dtype=rdt, device=rhs.device)
    beta_last = torch.zeros((), dtype=rdt, device=rhs.device)

    iteration = 0
    while iteration < max_iterations and not converged and not breakdown:
        with scope("pcg_matvec"):
            ap = model.apply_keff(p, stiffness_scale, mass_factor)
        with scope("pcg_dots"):
            denom = rdot(p, ap)
            denom_small = denom.abs() < _BREAKDOWN_TOL
            alpha = rho / torch.where(denom_small, 1.0, denom)

        # f32 axpys with an f32 scalar, as the reference's pcg_axpy.slang.
        # The per-iteration x/r Dirichlet re-clamp is an exact no-op by
        # invariant (p is zero on constrained axes and the identity rows
        # give ap = p = 0 there) and is elided, as in the reference.
        with scope("pcg_vector_update"):
            alpha32 = alpha.to(f32)
            x_new = x + alpha32 * p
            r_new = r - alpha32 * ap

        with scope("pcg_precondition"):
            z = model.apply_preconditioner(block_inverse, r_new)
        with scope("pcg_dots"):
            res_new = torch.sqrt(rdot(r_new, r_new))
            rho_new = rdot(r_new, z)
            rho_small = rho.abs() < _BREAKDOWN_TOL
            beta = rho_new / torch.where(rho_small, 1.0, rho)
            conds = (res_new <= tolerance, denom_small, rho_small)

        with scope("pcg_host_sync"):
            conv, denom_bd, rho_bd = _flags(*conds)
            rho_bd = rho_bd and not conv
            stop = conv or denom_bd or rho_bd
            if not denom_bd:
                x, r, residual_norm, alpha_last = x_new, r_new, res_new, alpha
                iteration += 1
            converged = conv
            breakdown = denom_bd or rho_bd
            if not stop:
                with scope("pcg_vector_update"):
                    p = (z + beta.to(f32) * p).masked_fill(bc, 0.0)
                rho, beta_last = rho_new, beta

    return (x, iteration, residual_norm, rhs_norm_true, alpha_last, beta_last,
            converged, breakdown)


def solve_pcg_fused(
    model,
    rhs: torch.Tensor,
    stiffness_scale,
    mass_factor,
    relative_tolerance,
    max_iterations,
    x0: torch.Tensor,
    warm_start: bool = True,
    reduction_dtype=torch.float64,
    vector_dtype=torch.float32,
    preconditioner=None,
):
    """Chronopoulos-Gear PCG: ONE fused reduction per iteration.

    Mathematically identical to classic PCG (Chronopoulos & Gear 1989), with
    the three dot products rearranged to be mutually independent:

        x += alpha p ; r -= alpha s          (s = A p, recurred)
        u  = M^-1 r ; w = A u
        gamma' = (r,u); delta = (w,u); rr = (r,r)
        beta  = gamma'/gamma
        alpha = gamma' / (delta - beta gamma'/alpha)
        p = u + beta p ; s = w + beta s

    One loop, one scalar recurrence and one host read of the flags per
    iteration; the iteration's vector work is one of two bodies, each on
    the carries ``(x, r, u, w, p, s)``:

    * the split body: the p/s recurrence the previous iteration decided
      runs at the top of the next, with that iteration's x/r axpys, as one
      ``cg_direction_update`` pass (U1, ``ops/cuda/pcg_vector_update``, in
      place on CUDA), which a stop never launches; p and s are made by the
      first from u and w (no beta).  Then the structured model's pc
      apply, matvec and three dots are one K2 launch on CUDA
      (``model.apply_pc_keff_dots``); a model without that method (the
      general path), or whose method returns None (absorbing faces, the
      slender route), composes ``apply_pc_keff`` and :func:`fused_dots`.
    * the whole-iteration body, with ``CIVIWAVE_MEGA_PCG=1`` on a model
      that builds the bundle (the structured model; the reference's
      ``_solve_pcg_megafused``, pcg.py:809-947): one K6 launch on CUDA.
      Body n feeds (u_{n-1}, w_{n-1}, p_{n-2}, s_{n-2}, alpha_{n-1},
      beta_{n-1}) to the kernel, which forms p_{n-1}/s_{n-1} in flight,
      applies the axpys, preconditions, applies the operator and emits
      the three dots.  beta starts at 0 on zero p/s, so the first body
      forms p_0 = u_0; the carries advance every body (on exit p/s are
      one iterate old and consumed by nothing).

    gamma, alpha, beta and beta_last freeze on the stopping body, and the
    count is iteration + 1 every body, as in the reference.
    """
    return _solve(_chronopoulos_gear_loop, model, rhs, stiffness_scale,
                  mass_factor, relative_tolerance, max_iterations, x0,
                  warm_start, reduction_dtype, vector_dtype, preconditioner)


def _chronopoulos_gear_loop(model, rhs, x, r, block_inverse, stiffness_scale,
                            mass_factor, relative_tolerance, max_iterations,
                            rdt, f32):
    """The loop of :func:`solve_pcg_fused`, from the clamped initial
    residual."""
    bc, psum = model.bc_mask, model.psum
    build = getattr(model, "build_fused_pcg_iteration", None)
    mega = None if build is None else build(
        block_inverse, stiffness_scale, mass_factor, rdt, f32
    )
    dots_fn = getattr(model, "apply_pc_keff_dots", None)

    with scope("pcg_pc_matvec"):
        u, w = model.apply_pc_keff(block_inverse, r, stiffness_scale, mass_factor)
    # one fused setup reduction: gamma0, delta0, ||r||^2 and ||rhs||^2
    gamma, delta0, rr0, rhs2 = fused_dots(
        [(r, u), (w, u), (r, r), (rhs, rhs)], rdt, psum
    )
    rhs_norm_true, tolerance = _norm_and_tolerance(rhs2, relative_tolerance)
    residual_norm = torch.sqrt(rr0)
    delta_small = delta0.abs() < _BREAKDOWN_TOL
    alpha = gamma / torch.where(delta_small, 1.0, delta0)
    with scope("pcg_host_sync"):
        converged, delta_bd = _flags(residual_norm <= tolerance, delta_small)
        breakdown = (not converged) and delta_bd
    alpha_last = torch.zeros((), dtype=rdt, device=rhs.device)
    beta_last = torch.zeros((), dtype=rdt, device=rhs.device)

    def split_body(carries, alpha, beta):
        x, r, u, w, p, s = carries
        with scope("pcg_vector_update"):
            x, r, p, s = cg_direction_update(bc, x, r, p, s, u, w, alpha, beta, f32)
        # constrained axes: p and s are zero there by recurrence, so x stays
        # = rhs and r stays = 0 bit for bit (the reference's elided clamp)
        with scope("pcg_pc_matvec_dots"):
            out = None if dots_fn is None else dots_fn(
                block_inverse, r, stiffness_scale, mass_factor, rdt
            )
        if out is None:
            with scope("pcg_pc_matvec"):
                u, w = model.apply_pc_keff(
                    block_inverse, r, stiffness_scale, mass_factor
                )
            with scope("pcg_fused_reduction"):
                out = u, w, fused_dots([(r, u), (w, u), (r, r)], rdt, psum)
        u, w, dots = out
        return (x, r, u, w, p, s), dots

    def mega_body(carries, alpha, beta):
        with scope("pcg_mega_iteration"):
            return mega(carries, alpha.to(f32), beta.to(f32))

    if mega is None:
        body, beta, carries = split_body, None, (x, r, u, w, None, None)
    else:
        # x, u (and p) are this loop's own tensors: K6 updates them in place
        body, beta = mega_body, torch.zeros((), dtype=rdt, device=rhs.device)
        carries = (x, r, u, w, torch.zeros_like(x), torch.zeros_like(x))
    iteration = 0
    while iteration < max_iterations and not converged and not breakdown:
        carries, (gamma_new, delta, rr) = body(carries, alpha, beta)
        with scope("pcg_scalars"):
            residual_norm = torch.sqrt(rr)
            gamma_small = gamma.abs() < _BREAKDOWN_TOL
            beta_new = gamma_new / torch.where(gamma_small, 1.0, gamma)
            alpha_denom = delta - beta_new * gamma_new / torch.where(
                alpha.abs() < _BREAKDOWN_TOL, 1.0, alpha
            )
            denom_small = alpha_denom.abs() < _BREAKDOWN_TOL
            alpha_new = gamma_new / torch.where(denom_small, 1.0, alpha_denom)
            conds = (residual_norm <= tolerance, gamma_small, denom_small)

        with scope("pcg_host_sync"):
            conv, g_bd, d_bd = _flags(*conds)
            alpha_last = alpha  # the step just applied
            iteration += 1
            converged = conv
            breakdown = (not conv) and (g_bd or d_bd)
            if not (converged or breakdown):
                gamma, alpha, beta, beta_last = gamma_new, alpha_new, beta_new, beta_new

    return (carries[0], iteration, residual_norm, rhs_norm_true, alpha_last,
            beta_last, converged, breakdown)


def solve_pcg_pipelined(
    model,
    rhs: torch.Tensor,
    stiffness_scale,
    mass_factor,
    relative_tolerance,
    max_iterations,
    x0: torch.Tensor,
    warm_start: bool = True,
    reduction_dtype=torch.float64,
    vector_dtype=torch.float32,
    preconditioner=None,
    replace_every: int = 10,
):
    """Ghysels-Vanroose pipelined PCG: the one reduction per iteration sits
    BEFORE the preconditioner apply and matvec, whose result it does not
    need (the reference's order, which lets XLA overlap its all-reduce
    with them; here a shard's all-reduce runs before them, in stream
    order).

    Port of the reference's ``solve_pcg_pipelined`` (pcg.py:551-806):

        gamma' = (r,u); delta = (w,u); rr = (r,r)    <- one reduction
        m = M^-1 w ; n = K_eff m                        (apply_pc_keff)
        beta  = gamma'/gamma ; alpha = gamma'/(delta - beta gamma'/alpha)
        z = n + beta z ; q = m + beta q ; p = u + beta p ; s = w + beta s
        x += alpha p ; r -= alpha s ; u -= alpha q ; w -= alpha z

    The same iterates as classic CG in exact arithmetic, with two more
    recurrence vectors (q, z), 8 axpys and one trailing pc+matvec per
    solve (the convergence check sees the residual one iteration late).
    The recurred u and w accumulate an absolute f32 error, so every
    ``replace_every`` iterations (``(iteration + 1) % replace_every ==
    0``, whatever the tolerance; 0 never) they are recomputed from the
    recurred r by one more ``apply_pc_keff`` — the Ghysels-Vanroose
    residual replacement (the reference's ADR-25).

    ``model.apply_pc_keff`` is K2 without dots on a CUDA f32 structured
    grid, the V-cycle then the operator under multigrid, and the
    composition elsewhere (the general path, a shard: K3 and K5).  The
    three dots are one :func:`fused_dots` with ``model.psum``: one
    all-reduce per iteration on a shard.  One host read of the flags per
    iteration; the pc+matvec is queued before it.  On a stop the carries
    keep their old values and the count does not advance, as the
    reference's ``where(stop, old, new)``.
    """
    return _solve(_pipelined_loop, model, rhs, stiffness_scale, mass_factor,
                  relative_tolerance, max_iterations, x0, warm_start,
                  reduction_dtype, vector_dtype, preconditioner,
                  replace_every=replace_every)


def _pipelined_loop(model, rhs, x, r, block_inverse, stiffness_scale,
                    mass_factor, relative_tolerance, max_iterations, rdt, f32,
                    replace_every):
    """The loop of :func:`solve_pcg_pipelined`, from the clamped initial
    residual."""
    bc, psum = model.bc_mask, model.psum

    def pc_keff(v):
        a, b = model.apply_pc_keff(block_inverse, v, stiffness_scale,
                                   mass_factor)
        return a.to(f32), b.to(f32)

    def pc_keff_masked(v):  # the setup and each replacement, as the reference
        a, b = pc_keff(v)
        return a.masked_fill(bc, 0.0), b.masked_fill(bc, 0.0)

    with scope("pcg_pc_matvec"):
        u, w = pc_keff_masked(r)
    rhs2, rr0 = fused_dots([(rhs, rhs), (r, r)], rdt, psum)
    rhs_norm_true, tolerance = _norm_and_tolerance(rhs2, relative_tolerance)

    # pre-loop check: an already-converged x0 (or max_iterations = 0)
    # reports the true initial residual and skips the loop
    residual_norm = torch.sqrt(rr0)
    with scope("pcg_host_sync"):
        (converged,) = _flags(residual_norm <= tolerance)
    breakdown = False

    p = torch.zeros_like(r)
    s, q, z = torch.zeros_like(r), torch.zeros_like(r), torch.zeros_like(r)
    gamma = torch.ones((), dtype=rdt, device=rhs.device)
    alpha = torch.ones((), dtype=rdt, device=rhs.device)
    alpha_last = torch.zeros((), dtype=rdt, device=rhs.device)
    beta_last = torch.zeros((), dtype=rdt, device=rhs.device)

    iteration = 0
    while iteration < max_iterations and not converged and not breakdown:
        with scope("pcg_pipelined_reduction"):
            gamma_new, delta, rr = fused_dots([(r, u), (w, u), (r, r)], rdt, psum)
        with scope("pcg_pc_matvec"):
            m, n = pc_keff(w)
        residual_norm = torch.sqrt(rr)

        first = iteration == 0
        gamma_small = (gamma.abs() < _BREAKDOWN_TOL) & (not first)
        beta = (
            torch.zeros((), dtype=rdt, device=rhs.device) if first
            else gamma_new / torch.where(gamma_small, 1.0, gamma)
        )
        alpha_denom = delta - beta * gamma_new / torch.where(
            alpha.abs() < _BREAKDOWN_TOL, 1.0, alpha
        )
        denom_small = alpha_denom.abs() < _BREAKDOWN_TOL
        alpha_new = gamma_new / torch.where(denom_small, 1.0, alpha_denom)

        with scope("pcg_host_sync"):
            conv, g_bd, d_bd = _flags(
                residual_norm <= tolerance, gamma_small, denom_small
            )
            converged = conv
            breakdown = (not conv) and (g_bd or d_bd)
        if converged or breakdown:
            break
        beta32, alpha32 = beta.to(f32), alpha_new.to(f32)
        z = n + beta32 * z
        q = m + beta32 * q
        p = u + beta32 * p
        s = w + beta32 * s
        x = x + alpha32 * p
        r = r - alpha32 * s
        u = u - alpha32 * q
        w = w - alpha32 * z
        if replace_every and (iteration + 1) % replace_every == 0:
            with scope("pcg_residual_replacement"):
                u, w = pc_keff_masked(r)
        gamma, alpha = gamma_new, alpha_new
        alpha_last, beta_last = alpha_new, beta
        iteration += 1

    return (x, iteration, residual_norm, rhs_norm_true, alpha_last, beta_last,
            converged, breakdown)
