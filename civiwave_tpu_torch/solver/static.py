"""Static equilibrium solve: K u = f with Dirichlet values.

Port of :mod:`civiwave_tpu.solver.static`.  The static problem is the
Newmark operator with ``stiffness_scale = 1`` and ``mass_factor = 0``: the
same matrix-free ``apply_keff``, the same Dirichlet semantics and the same
block-Jacobi PCG, so every route of the port serves statics (the
structured kernels K1-K3 and K6, the general path's K7 and G1).  The
Dirichlet rows are identity rows and the preconditioner is the stiffness
diagonal's blocks alone; no kernel divides by the mass term.

:func:`solve_static` is the reference's function on the model's device.
The reference's ``solve_static_jit`` only compiles it with ``jax.jit``; the
port runs eagerly and has no such twin.  :func:`static_oracle` is the dense
FP64 host solve, a copy of the reference's.

The runner's ``--static`` mode (``runner.run_static``) drives
:func:`solve_static` to the scenario's pause tolerance.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .pcg import PcgTelemetry, solve_pcg


def solve_static(
    model,
    external_force: torch.Tensor,
    tolerance: float = 1.0e-8,
    max_iterations: int = 4000,
    reduction_precision: str = "fp64",
    vector_precision: str = "fp32",
    preconditioner=None,
    variant: str = "auto",
    replace_every: int = 10,
) -> Tuple[torch.Tensor, PcgTelemetry]:
    """Solve K u = f_ext (+ Dirichlet targets) to ``tolerance`` from a cold
    start (x0 = 0).

    Returns the displacement in the model's solver-vector layout (use
    ``model.to_nodal`` for host rows) and the PCG telemetry.  The
    preconditioner is built at (ss, mf) = (1, 0) when not supplied.
    ``variant`` 'auto' is what the reference runs: fused (K2, or K6 under
    ``CIVIWAVE_MEGA_PCG=1``) on a structured model on CUDA in f32, classic
    on the CPU, on the general path and under multigrid.  ``replace_every``
    is the pipelined variant's residual-replacement period.  On a shard
    (a structured slab or tile, a general row block) the clamp and the cold
    start are row-local, the vectors are the shard's and every dot goes
    through ``model.psum``; 'auto' is then fused, as under the reference's
    GSPMD, except on a general shard without the halo operator.  Every rank
    of the group calls it.
    """
    vdt = torch.float64 if vector_precision == "fp64" else torch.float32
    scalar = np.float64 if vector_precision == "fp64" else np.float32
    one, zero = scalar(1.0), scalar(0.0)
    rhs = torch.where(
        model.bc_mask, model.bc_value.to(vdt), external_force.to(vdt)
    )
    if preconditioner is None:
        preconditioner = model.build_preconditioner(one, zero)
    x_seed = torch.zeros(model.vector_shape, dtype=vdt, device=rhs.device)
    return solve_pcg(
        model,
        rhs,
        one,
        zero,
        float(tolerance),
        int(max_iterations),
        x_seed,
        warm_start=False,
        reduction_dtype=(
            torch.float32 if reduction_precision == "fp32" else torch.float64
        ),
        vector_dtype=vdt,
        preconditioner=preconditioner,
        variant=variant,
        replace_every=replace_every,
    )


def static_oracle(mesh, preprocess_outputs, cfg, materials_list):
    """Dense FP64 static reference solve on the host (numpy).  Returns
    (N, 3) rows in mesh order."""
    from ..physics import loads as loads_mod
    from ..physics import oracle

    assembly = oracle.assemble_linear_system(
        mesh, preprocess_outputs, materials_list
    )
    dirichlet = oracle.build_dirichlet_conditions(mesh, cfg)
    f = loads_mod.assemble_load_vector(
        mesh, cfg, preprocess_outputs, 0.0
    ).reshape(-1).astype(np.float64)
    k_bc = assembly.stiffness.copy()
    oracle.apply_dirichlet(k_bc, f, dirichlet, None)  # state unused
    # the oracle's CG converges on the ABSOLUTE residual; 1e-8 relative:
    # diagonal-preconditioned CG stalls near f64 roundoff on ill-conditioned
    # slender geometries, and the parity budget is 2.5e-4
    tol = 1.0e-8 * max(float(np.linalg.norm(f)), 1.0)
    u, stats = oracle.conjugate_gradient(
        k_bc, f, max_iterations=20000, tolerance=tol
    )
    assert stats.converged, "static oracle CG failed to converge"
    return u.reshape(-1, 3)


def true_relative_residual(model, external_force, u) -> float:
    """||f - K u|| / ||f||, all in f64 on the model's device: f is the
    Dirichlet-clamped static right-hand side, K the static operator
    (identity rows on constrained axes) in its plain form.  The solve's
    real accuracy, whatever residual a PCG variant recurs."""
    from ..mesh.structured import StructuredModel

    if isinstance(model, StructuredModel):
        from ..ops.structured import apply_keff_structured_plain as plain
    else:
        from ..ops.apply_keff import apply_keff_plain as plain
    f64 = torch.float64
    rhs = torch.where(model.bc_mask, model.bc_value.to(f64), external_force.to(f64))
    ku = plain(model, u.to(f64), 1.0, 0.0)
    return float((rhs - ku).norm() / rhs.norm().clamp_min(1e-300))
