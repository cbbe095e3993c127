"""Geometric multigrid V(1,1) preconditioner for the structured route.

Port of :mod:`civiwave_tpu.ops.multigrid` (its ADR-15): block-Jacobi PCG
is iteration-bound at scale, and a coarse grid removes the smooth error
components block-Jacobi cannot damp.  Every piece keeps the preconditioner
symmetric positive definite, which PCG requires:

* **Hierarchy**: vertex-centred coarsening of the (X, Y, Z) node grid,
  coarse node i <-> fine node 2i, coarse extent (f + 1) // 2.  Each coarse
  level is a smaller :class:`StructuredModel` of doubled spacing, so the
  structured operator (K1 on CUDA) is the coarse operator: for nested
  trilinear hexes P^T A P equals the rediscretized 2h operator.
* **Transfers**: trilinear prolongation P (even fine planes copy, odd ones
  average their coarse neighbours, a tensor product over the axes) and
  restriction exactly P^T.  Coarse lumped mass is P^T m_f: total mass is
  conserved and the interior value is rho (2h)^3.
* **Smoother**: damped per-node block-Jacobi z += omega B^-1 (r - A z),
  with omega = 1 / (1.1 max(lambda_K, 1)) and lambda_K = lambda_max(B_K^-1
  K) from a power iteration per level at build, so A <= max(lambda_K, 1) B
  for every (ss, mf) >= 0.
* **Cycle**: symmetric V(1,1): pre-smooth from zero, coarse correction,
  post-smooth with the same smoother; the coarsest level takes
  ``_COARSE_SWEEPS`` smoother sweeps.
* **Dirichlet**: residuals entering the cycle are zero on constrained
  axes, transfers are clamped on both sides, and every level's identity
  rows keep constrained components at zero.

A coarse level's mass is not the ``m8`` times 0.5 per boundary axis that
the kernels synthesize (an even fine node count puts 0.875 on the high
face), so each level carries a ``mass_correction`` that the operator adds
after K1 on CUDA (``ops.structured.correct_synthesized_mass``).

The reference moves its power iteration to the host CPU and its levels to
the device in one bulk transfer (TPU workarounds); here the whole build
runs on the model's own device.  Scope, as in the reference: homogeneous,
unsharded structured grids; ``attach_multigrid`` falls back to
block-Jacobi with a note on a heterogeneous grid (no constant coarse
stencil) and on a shard, and leaves a grid too small to coarsen as it is.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..mesh.structured import StructuredModel, interior_mass
from ..utils.profiling import scope
from . import structured as _ops

_MIN_COARSE_DIM = 3  # never coarsen an axis below 3 nodes
_MIN_COARSE_NODES = 300  # stop once a level is this small
_MAX_LEVELS = 6  # coarse levels cap
_COARSE_SWEEPS = 4  # smoother sweeps standing in for the coarsest solve
_POWER_ITERS = 24
# levels above this node count reuse the next coarser level's spectral
# estimate (the damped-Jacobi spectrum is grid-self-similar)
_POWER_MAX_NODES = 150_000
_SAFETY = 1.1


# --------------------------------------------------------------------------
# transfers (trilinear P and exactly-P^T restriction, tensor-product)
# --------------------------------------------------------------------------


def _prolong_axis(x: torch.Tensor, axis: int, fine_size: int) -> torch.Tensor:
    """1-D trilinear prolongation along ``axis``: c -> fine_size nodes.
    Fine node 2i = coarse i; fine node 2i+1 = (coarse i + coarse i+1) / 2,
    a missing neighbour past the end counting 0 (the transpose of the
    restriction's zero pad)."""
    c = x.shape[axis]
    x_next = torch.cat(
        [x.narrow(axis, 1, c - 1), torch.zeros_like(x.narrow(axis, 0, 1))],
        dim=axis,
    )
    odd = 0.5 * (x + x_next)
    inter = torch.stack([x, odd], dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = 2 * c
    return inter.reshape(shape).narrow(axis, 0, fine_size)


def _restrict_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """1-D restriction along ``axis``, the transpose of
    :func:`_prolong_axis`: coarse i = fine 2i + (fine 2i-1 + fine 2i+1)/2."""
    f = x.shape[axis]
    c = (f + 1) // 2
    if 2 * c - f:
        pad = torch.zeros_like(x.narrow(axis, 0, 1))
        x = torch.cat([x, pad], dim=axis)
    shape = list(x.shape)
    shape[axis] = c
    shape.insert(axis + 1, 2)
    xr = x.reshape(shape)
    even = xr.select(axis + 1, 0)
    odd = xr.select(axis + 1, 1)
    odd_prev = torch.cat(
        [torch.zeros_like(odd.narrow(axis, 0, 1)), odd.narrow(axis, 0, c - 1)],
        dim=axis,
    )
    return even + 0.5 * (odd + odd_prev)


def prolong(x: torch.Tensor, fine_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Coarse CSG vector (3, cX, cY, cZ) -> fine (3, *fine_shape)."""
    for ax in range(3):
        x = _prolong_axis(x, 1 + ax, fine_shape[ax])
    return x


def restrict(x: torch.Tensor) -> torch.Tensor:
    """Fine CSG vector (3, X, Y, Z) -> coarse (3, (X+1)//2, ...); the
    transpose of :func:`prolong` for the matching shapes."""
    for ax in range(3):
        x = _restrict_axis(x, 1 + ax)
    return x


# --------------------------------------------------------------------------
# hierarchy construction (once per model)
# --------------------------------------------------------------------------


def _restrict_axis_np(x: np.ndarray, axis: int) -> np.ndarray:
    """Host twin of :func:`_restrict_axis` in numpy (the coarse lumped
    mass P^T m_f is restricted with it in f64, as the reference does)."""
    f = x.shape[axis]
    c = (f + 1) // 2
    pad = 2 * c - f
    if pad:
        width = [(0, 0)] * x.ndim
        width[axis] = (0, pad)
        x = np.pad(x, width)
    shape = list(x.shape)
    shape[axis] = c
    shape.insert(axis + 1, 2)
    xr = x.reshape(shape)
    even = np.take(xr, 0, axis=axis + 1)
    odd = np.take(xr, 1, axis=axis + 1)
    odd_prev = np.zeros_like(odd)
    src = [slice(None)] * odd.ndim
    dst = [slice(None)] * odd.ndim
    src[axis] = slice(0, c - 1)
    dst[axis] = slice(1, c)
    odd_prev[tuple(dst)] = odd[tuple(src)]
    return even + 0.5 * (odd + odd_prev)


def _coarsen_model(model: StructuredModel) -> StructuredModel | None:
    """One vertex-centred coarse level of a homogeneous structured model
    (the cells of its whole grid, pad planes and rows included, at doubled
    spacing), or None when an axis would fall below ``_MIN_COARSE_DIM``
    nodes.  Its ``m8`` comes from its interior node, and it carries the
    mass correction the kernels need."""
    fx, fy, fz = model.grid_shape
    cx, cy, cz = ((d + 1) // 2 for d in (fx, fy, fz))
    if min(cx, cy, cz) < _MIN_COARSE_DIM:
        return None
    dev = model.device
    # constraints by injection at the coincident (even-index) fine nodes
    bc_c = model.bc_mask[:, ::2, ::2, ::2].contiguous()
    # coarse lumped mass = P^T m_f, restricted in f64 on the host
    mass_c = model.mass_grid.cpu().numpy().astype(np.float64)
    for ax in range(3):
        mass_c = _restrict_axis_np(mass_c, ax)
    mass_c = mass_c.astype(np.float32)
    cells = (cx - 1, cy - 1, cz - 1)
    spacing = tuple(2.0 * float(h) for h in model.spacing)
    level = StructuredModel(
        lam_grid=torch.full(cells, model.lam0, dtype=torch.float32, device=dev),
        mu_grid=torch.full(cells, model.mu0, dtype=torch.float32, device=dev),
        mass_grid=torch.as_tensor(mass_c, device=dev),
        bc_mask=bc_c,
        bc_value=torch.zeros((3, cx, cy, cz), dtype=torch.float32, device=dev),
        position0=torch.zeros((1, 3), dtype=torch.float32, device=dev),
        stencil_table=torch.as_tensor(
            _ops.class_stencil_table(spacing, model.lam0, model.mu0),
            device=dev,
        ),
        sweep_taps=_ops.sweep_taps(spacing, model.lam0, model.mu0),
        nx=cells[0],
        ny=cells[1],
        nz=cells[2],
        node_count=cx * cy * cz,
        padded_node_count=cx * cy * cz,
        spacing=spacing,
        lam0=model.lam0,
        mu0=model.mu0,
        m8=interior_mass(mass_c, *cells),
    )
    return dataclasses.replace(level, mass_correction=_ops.mass_correction(level))


def _estimate_lambda_max(model: StructuredModel) -> float:
    """lambda_max(B_K^-1 K) by power iteration on the free subspace (the
    pure-stiffness extreme; max(lambda, 1) then bounds every (ss, mf)), on
    the model's device from ``default_rng(7)``."""
    one, zero = np.float32(1.0), np.float32(0.0)
    binv = _ops.build_block_jacobi_inverse_structured(model, one, zero)
    rng = np.random.default_rng(7)
    w = torch.as_tensor(
        rng.standard_normal(model.vector_shape).astype(np.float32),
        device=model.device,
    ).masked_fill(model.bc_mask, 0.0)
    w = w / torch.sqrt(torch.sum(w * w))
    lam = torch.ones((), dtype=torch.float32, device=model.device)
    for _ in range(_POWER_ITERS):
        aw = _ops.apply_keff_structured(model, w, one, zero)
        y = _ops.apply_preconditioner_structured(
            model, binv, aw.masked_fill(model.bc_mask, 0.0)
        )
        lam = torch.sqrt(torch.sum(y * y))
        w = y / torch.clamp_min(lam, 1.0e-30)
    return float(lam)


SHARD_REASON = "sharded decomposition (coarse levels are not distributed)"
HETEROGENEOUS_REASON = "heterogeneous material grid"


def fall_back_to_block_jacobi(model: StructuredModel, reason: str):
    """``model`` on block-Jacobi, with the reference's note on stderr."""
    print(
        f"note: multigrid preconditioner unavailable ({reason}); "
        "falling back to block_jacobi",
        file=sys.stderr,
    )
    if model.preconditioner == "block_jacobi" and not model.mg_levels:
        return model
    return dataclasses.replace(
        model, preconditioner="block_jacobi", mg_levels=(), mg_omegas=()
    )


def attach_multigrid(model: StructuredModel) -> StructuredModel:
    """A copy of ``model`` with its hierarchy attached and
    ``preconditioner='multigrid'``; ``model`` on block-Jacobi with the
    reference's note on stderr on a heterogeneous grid (the coarse levels
    need one material) and on a shard, and unchanged when the grid is too
    small to coarsen."""
    if not model.homogeneous:
        return fall_back_to_block_jacobi(model, HETEROGENEOUS_REASON)
    if model.shard_group is not None:
        return fall_back_to_block_jacobi(model, SHARD_REASON)
    levels: list[StructuredModel] = []
    cur = model
    while len(levels) < _MAX_LEVELS:
        nxt = _coarsen_model(cur)
        if nxt is None:
            break
        levels.append(nxt)
        cur = nxt
        if cur.node_count <= _MIN_COARSE_NODES:
            break
    if not levels:
        return model

    # spectral bounds per level, coarsest first so that large levels reuse
    # the self-similar coarse estimate instead of full-size matvecs
    all_levels = [model] + levels
    lambdas = [0.0] * len(all_levels)
    prev = None
    for i in range(len(all_levels) - 1, -1, -1):
        lvl = all_levels[i]
        if prev is not None and lvl.node_count > _POWER_MAX_NODES:
            lambdas[i] = prev
        else:
            lambdas[i] = _estimate_lambda_max(lvl)
            prev = lambdas[i]
    omegas = tuple(1.0 / (_SAFETY * max(lam, 1.0)) for lam in lambdas)
    return dataclasses.replace(
        model, mg_levels=tuple(levels), mg_omegas=omegas,
        preconditioner="multigrid",
    )


# --------------------------------------------------------------------------
# the V-cycle
# --------------------------------------------------------------------------


class MultigridPreconditioner(NamedTuple):
    """Per-level packed block inverses (6, X, Y, Z) and the K_eff scalars
    the V-cycle's residual matvecs need."""

    inverses: Tuple[torch.Tensor, ...]
    stiffness_scale: float
    mass_factor: float


def _block_inverse_scaled(model, stiffness_scale, mass_factor):
    """Symmetric-packed block-Jacobi inverse with each node's 3x3 block
    divided by its largest diagonal before the inversion: a coarse level's
    diagonal grows as mf rho (2^l h)^3 (~3e14 by level 5 of the large
    grids), where the plain f32 adjugate and determinant overflow to
    inf - inf.  The same inverse in exact arithmetic (inv(B) = inv(B/s)/s)."""
    blocks = _ops.assemble_node_blocks_structured(
        model, stiffness_scale, mass_factor
    )
    diag = torch.stack([blocks[0, 0], blocks[1, 1], blocks[2, 2]])
    s = torch.clamp_min(diag.max(dim=0).values, 1.0e-30)
    inverse = _ops._invert_spd_3x3_lead(blocks / s[None, None]) / s[None, None]
    return torch.stack(
        [
            inverse[0, 0],
            inverse[1, 1],
            inverse[2, 2],
            inverse[0, 1],
            inverse[0, 2],
            inverse[1, 2],
        ]
    )


def build_mg_preconditioner(model: StructuredModel, stiffness_scale,
                            mass_factor) -> MultigridPreconditioner:
    """Every level's scaled block inverse at (ss, mf)."""
    invs = tuple(
        _block_inverse_scaled(lvl, stiffness_scale, mass_factor)
        for lvl in (model,) + model.mg_levels
    )
    return MultigridPreconditioner(invs, stiffness_scale, mass_factor)


def apply_mg_preconditioner(model: StructuredModel,
                            precond: MultigridPreconditioner, residual):
    """z = V_cycle(r), symmetric positive definite by construction."""
    levels = (model,) + model.mg_levels
    return _vcycle(levels, precond.inverses, model.mg_omegas, 0, residual,
                   precond.stiffness_scale, precond.mass_factor)


def _vcycle(levels, invs, omegas, li, r, ss, mf):
    with scope(f"mg_level{li}"):
        return _vcycle_level(levels, invs, omegas, li, r, ss, mf)


def _vcycle_level(levels, invs, omegas, li, r, ss, mf):
    model = levels[li]
    om = float(np.float32(omegas[li]))
    # pre-smooth from zero (constrained components of r are zero and the
    # apply zeroes constrained outputs)
    z = om * _ops.apply_preconditioner_structured(model, invs[li], r)
    if li == len(levels) - 1:
        for _ in range(_COARSE_SWEEPS - 1):
            resid = r - _ops.apply_keff_structured(model, z, ss, mf)
            z = z + om * _ops.apply_preconditioner_structured(
                model, invs[li], resid
            )
        return z

    d = r - _ops.apply_keff_structured(model, z, ss, mf)
    coarse = levels[li + 1]
    rc = restrict(d).masked_fill(coarse.bc_mask, 0.0)
    ec = _vcycle(levels, invs, omegas, li + 1, rc, ss, mf)
    z = z + prolong(ec, model.grid_shape).masked_fill(model.bc_mask, 0.0)

    # post-smooth (the same smoother: a symmetric cycle operator)
    resid = r - _ops.apply_keff_structured(model, z, ss, mf)
    return z + om * _ops.apply_preconditioner_structured(model, invs[li], resid)
