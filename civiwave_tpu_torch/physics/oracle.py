"""Dense CPU reference solver — the validation oracle (numpy, FP64).

Copy of :mod:`civiwave_tpu.physics.oracle` (a rebuild of the reference
engine's src/physics/solver.cpp:159-378).  Intentionally O(N^2) memory and
small-mesh-only: it is the second parity anchor of the general path beside
the JAX package, for tiny meshes.  The pack also takes its Dirichlet
tables from here (``gather_group_nodes``, ``build_dirichlet_conditions``).

Because preprocessing expands hex8 elements into Gauss-point quadrature
rows, this dense assembly consumes the *same* quadrature tables as the
matrix-free operator — so tet4 and hex8 are both covered by one code path
(the reference's dense assembly was tet-only, solver.cpp:275-281).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..config.schema import Config
from ..mesh.model import Mesh, SENTINEL
from ..mesh.preprocess import PreprocessOutputs
from . import loads as loads_mod
from . import newmark
from .materials import ElasticProperties, RayleighCoefficients


@dataclass
class Assembly:
    """Dense stiffness + lumped mass diagonal (solver.hpp Assembly)."""

    stiffness: np.ndarray  # (dof, dof) float64
    mass_diag: np.ndarray  # (dof,) float64


@dataclass
class DirichletConditions:
    """Per-dof constraint mask + target values (solver.hpp)."""

    mask: np.ndarray  # (dof,) bool
    targets: np.ndarray  # (dof,) float64


@dataclass
class SolveStats:
    iterations: int = 0
    residual_norm: float = 0.0
    converged: bool = False


@dataclass
class StepResult:
    state: newmark.State
    stats: SolveStats


def _row_b_matrices(gradients: np.ndarray) -> np.ndarray:
    """Strain-displacement matrices B (Q, 6, 24) from gradients (Q, 8, 3).

    Same fill pattern as build_element_stiffness (solver.cpp:39-61), Voigt
    order (xx, yy, zz, xy, yz, xz) with engineering shear.
    """
    q = gradients.shape[0]
    b = np.zeros((q, 6, 24), dtype=np.float64)
    gx, gy, gz = gradients[..., 0], gradients[..., 1], gradients[..., 2]
    for local in range(8):
        col = local * 3
        b[:, 0, col + 0] = gx[:, local]
        b[:, 1, col + 1] = gy[:, local]
        b[:, 2, col + 2] = gz[:, local]
        b[:, 3, col + 0] = gy[:, local]
        b[:, 3, col + 1] = gx[:, local]
        b[:, 4, col + 1] = gz[:, local]
        b[:, 4, col + 2] = gy[:, local]
        b[:, 5, col + 0] = gz[:, local]
        b[:, 5, col + 2] = gx[:, local]
    return b


def assemble_linear_system(
    mesh: Mesh,
    preprocess: PreprocessOutputs,
    materials: Sequence[ElasticProperties],
) -> Assembly:
    """Dense K from quadrature rows + lumped mass diag (solver.cpp:267-310)."""
    n = mesh.dof_count
    stiffness = np.zeros((n, n), dtype=np.float64)

    conn = preprocess.quad_connectivity  # (Q, 8)
    grads = preprocess.quad_gradients  # (Q, 8, 3)
    volume = preprocess.quad_volume  # (Q,)
    d_all = np.stack([m.stiffness for m in materials])  # (M, 6, 6)
    d_rows = d_all[preprocess.quad_material_index]  # (Q, 6, 6)

    b = _row_b_matrices(grads)  # (Q, 6, 24)
    db = np.einsum("qij,qjk->qik", d_rows, b)
    ke = np.einsum("qji,qjk->qik", b, db) * volume[:, None, None]  # (Q, 24, 24)

    # scatter to dense: dof index per local slot; SENTINEL slots have zero
    # gradients so their Ke rows/cols are zero — scatter them to dof 0 safely.
    conn_safe = np.where(conn == SENTINEL, 0, conn).astype(np.int64)
    dof = (conn_safe[:, :, None] * 3 + np.arange(3)[None, None, :]).reshape(-1, 24)
    rows = np.repeat(dof, 24, axis=1).reshape(-1)
    cols = np.tile(dof, (1, 24)).reshape(-1)
    np.add.at(stiffness, (rows, cols), ke.reshape(-1))

    mass_diag = np.repeat(preprocess.lumped_mass, 3)
    return Assembly(stiffness=stiffness, mass_diag=mass_diag)


def gather_group_nodes(mesh: Mesh, group_id: int) -> np.ndarray:
    """All node indices of a group: surface nodes + tagged nodes
    (solver.cpp:92-123)."""
    collected = []
    surface_indices = mesh.surface_groups.get(group_id)
    if surface_indices is not None and len(surface_indices):
        conn = mesh.surfaces[surface_indices]
        collected.append(conn[conn != SENTINEL].astype(np.int64))
    node_indices = mesh.node_groups.get(group_id)
    if node_indices is not None and len(node_indices):
        collected.append(np.asarray(node_indices, dtype=np.int64))
    if not collected:
        return np.zeros((0,), dtype=np.int64)
    return np.unique(np.concatenate(collected))


def build_dirichlet_conditions(mesh: Mesh, cfg: Config) -> DirichletConditions:
    """Per-dof mask + targets from config fixes (solver.cpp:312-352)."""
    n = mesh.dof_count
    mask = np.zeros(n, dtype=bool)
    targets = np.zeros(n, dtype=np.float64)
    name_to_group = mesh.group_name_to_id()
    for fix in cfg.dirichlet:
        group_id = name_to_group.get(fix.group)
        if group_id is None:
            continue
        nodes = gather_group_nodes(mesh, group_id)
        for axis in range(3):
            if not fix.constrain_axis[axis]:
                continue
            value = fix.value[axis] if fix.value[axis] is not None else 0.0
            dofs = nodes * 3 + axis
            mask[dofs] = True
            targets[dofs] = value
    return DirichletConditions(mask=mask, targets=targets)


def apply_dirichlet(
    matrix: np.ndarray,
    rhs: np.ndarray,
    conditions: DirichletConditions,
    state: newmark.State,
) -> None:
    """Row/col zero + identity diag; rhs = target on constrained dofs.

    DELIBERATE DEVIATION from solver.cpp:242-263, which sets
    ``rhs = target - u``.  The effective system assembled by
    ``build_effective_rhs``/``build_effective_stiffness`` is the textbook
    *total-displacement* Newmark form — ``K_eff u_{n+1} = rhs`` (Bathe
    eq. 9.104; verify: at equilibrium ``K u = F`` the solution is ``u``) —
    so the constrained solution component must equal the target itself.
    The reference mixed the two conventions (total-form RHS, delta-form
    clamp and update), which is exact for the first step from rest (its
    only tested case, newmark_stepper_test.cpp:205-239) but drifts for
    multi-step runs.  ``state`` is kept in the signature for call-site
    parity.
    """
    del state
    fixed = np.nonzero(conditions.mask)[0]
    matrix[fixed, :] = 0.0
    matrix[:, fixed] = 0.0
    matrix[fixed, fixed] = 1.0
    rhs[fixed] = conditions.targets[fixed]


def conjugate_gradient(
    matrix: np.ndarray,
    rhs: np.ndarray,
    max_iterations: int,
    tolerance: float,
):
    """Diagonal-preconditioned CG in FP64 (solver.cpp:159-225)."""
    n = rhs.shape[0]
    x = np.zeros(n, dtype=np.float64)
    r = rhs.astype(np.float64).copy()
    diag = np.diagonal(matrix).copy()
    diag = np.where(np.abs(diag) > np.finfo(np.float64).eps, diag, 1.0)
    z = r / diag
    p = z.copy()
    rho = float(r @ z)
    residual_norm = float(np.sqrt(r @ r))
    stats = SolveStats()
    if residual_norm <= tolerance:
        stats.converged = True
        stats.residual_norm = residual_norm
        return x, stats

    for iteration in range(max_iterations):
        ap = matrix @ p
        denom = float(p @ ap)
        if abs(denom) < np.finfo(np.float64).eps:
            break
        alpha = rho / denom
        x += alpha * p
        r -= alpha * ap
        residual_norm = float(np.sqrt(r @ r))
        stats.iterations = iteration + 1
        if residual_norm <= tolerance:
            stats.converged = True
            stats.residual_norm = residual_norm
            return x, stats
        z = r / diag
        rho_new = float(r @ z)
        beta = rho_new / rho
        rho = rho_new
        p = z + beta * p

    stats.converged = False
    stats.residual_norm = residual_norm
    return x, stats


def solve_newmark_step(
    assembly: Assembly,
    rayleigh: RayleighCoefficients,
    dirichlet: DirichletConditions,
    mesh: Mesh,
    cfg: Config,
    preprocess: PreprocessOutputs,
    coeffs: newmark.Coefficients,
    previous_state: newmark.State,
    time: float,
    tolerance: float,
    max_iterations: int,
    external_load: Optional[np.ndarray] = None,
    damp: Optional[np.ndarray] = None,
) -> StepResult:
    """Full dense Newmark step (solver.cpp:354-378).

    ``damp``: optional dense (3N, 3N) viscous damping matrix (the
    Lysmer-Kuhlemeyer absorbing-boundary twin, physics/absorbing.py):
    K_eff += a1 C and rhs += C (a1 u + a4 v + a5 a), the same algebra as
    the Rayleigh terms (newmark.cpp:83-133)."""
    if external_load is None:
        load = loads_mod.assemble_load_vector(mesh, cfg, preprocess, time).reshape(-1)
    else:
        load = external_load.reshape(-1)
    rhs = newmark.build_effective_rhs(
        load, assembly.stiffness, assembly.mass_diag, rayleigh, coeffs, previous_state
    )
    keff = newmark.build_effective_stiffness(
        assembly.stiffness, assembly.mass_diag, rayleigh, coeffs
    )
    if damp is not None:
        keff = keff + coeffs.a1 * damp
        damping_rhs = (
            coeffs.a1 * previous_state.displacement
            + coeffs.a4 * previous_state.velocity
            + coeffs.a5 * previous_state.acceleration
        )
        rhs = rhs + damp @ damping_rhs
    apply_dirichlet(keff, rhs, dirichlet, previous_state)
    solution, stats = conjugate_gradient(keff, rhs, max_iterations, tolerance)
    # the solve yields TOTAL u_{n+1}; the kinematic update consumes the
    # increment (see apply_dirichlet docstring for the deviation rationale —
    # solver.cpp:367 fed the raw solution in as the increment)
    delta = solution - previous_state.displacement
    next_state = newmark.update_state(coeffs, previous_state, delta)
    fixed = np.nonzero(dirichlet.mask)[0]
    next_state.displacement[fixed] = dirichlet.targets[fixed]
    return StepResult(state=next_state, stats=stats)
