"""Implicit Newmark-beta frame orchestration on device tensors.

Port of :mod:`civiwave_tpu.solver.stepper` (the reference's
newmark_stepper.cpp:1094-1399).  Step order preserved exactly:

1. coefficients a0..a5 from the *current* dt (host f64 scalars);
2. predictor u_pred/v_pred from the pre-step state;
3. effective RHS from the pre-step state (NOT the predictor) with mass +
   Rayleigh terms, and the beta_R * K * damping_rhs matvec through the
   stiffness-only operator; absorbing faces add C * damping_rhs and the
   step's model copy carries ``damp_factor = a1`` (K_eff += a1 C);
4. Dirichlet RHS clamp (total-displacement form: rhs = bc_value);
5. PCG with warm start + runtime/pause tolerance;
6. update u = u_pred + d, a = d/(beta dt^2), v = v_pred + gamma/(beta dt) d.

Every f64 -> f32 scalar cast of the reference is mirrored explicitly with
``np.float32(...)``; the vector arithmetic then runs in f32 on the model's
device.  ``dt``, the tolerance and the iteration cap are plain arguments:
nothing is rebuilt when they change except the hoisted preconditioner,
which depends on dt.  ``NewmarkStepper.save_checkpoint`` /
``restore_checkpoint`` carry a run across processes
(``utils/checkpoint.py``).  Under a torch.profiler trace the phases are
the reference's named ranges (``utils/profiling.py``), and a frame's
preconditioner build and telemetry read the ranges ``pc_build`` and
``telemetry_read``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..config.schema import SolverSettings, TimeSettings
from ..mesh.pack import SimState
from ..physics.materials import RayleighCoefficients
from ..utils import profiling
from ..utils.profiling import scope
from .pcg import PcgTelemetry, resolve_variant, solve_pcg


@dataclass(frozen=True)
class AdaptivePolicy:
    """Adaptive dt knobs (newmark_stepper.hpp:56-63)."""

    low_iteration_ratio: float = 0.3
    increase_factor: float = 1.1
    decrease_factor: float = 0.5


@dataclass
class StepTelemetry:
    """Host-side per-frame telemetry (newmark_stepper.hpp:68-79).

    ``Simulation.run`` fills the last three: the frame's host syncs
    (``utils.profiling.host_syncs``, its increase over the frame) and the
    frame's start and end on the host, ``time.time_ns()`` (Unix-epoch
    nanoseconds, the clock of torch.profiler's events)."""

    simulation_time: float
    time_step: float
    applied_tolerance: float
    paused_mode: bool
    dt_increased: bool = False
    dt_decreased: bool = False
    dt_clamped_min: bool = False
    dt_clamped_max: bool = False
    pcg_iterations: int = 0
    pcg_residual_norm: float = 0.0
    pcg_rhs_norm: float = 0.0
    pcg_alpha_last: float = 0.0
    pcg_beta_last: float = 0.0
    pcg_converged: bool = False
    pcg_breakdown: bool = False
    host_syncs: int = 0
    host_start_ns: int = 0
    host_end_ns: int = 0


class StepOut(NamedTuple):
    state: SimState
    pcg: PcgTelemetry


def effective_scalars(
    dt: float,
    rayleigh_alpha: float,
    rayleigh_beta: float,
    newmark_beta: float = 0.25,
    newmark_gamma: float = 0.5,
    vector_precision: str = "fp32",
):
    """(stiffness_scale, mass_factor) in the vector precision — bitwise the
    values newmark_step derives from the same f64 dt
    (newmark_stepper.cpp:1322-1326), for prebuilding the preconditioner."""
    a0 = 1.0 / (newmark_beta * dt * dt)
    a1 = newmark_gamma / (newmark_beta * dt)
    scalar = np.float64 if vector_precision == "fp64" else np.float32
    return (
        scalar(1.0 + a1 * rayleigh_beta),
        scalar(a0 + a1 * rayleigh_alpha),
    )


def newmark_step(
    model,
    state: SimState,
    external_force: torch.Tensor,
    dt: float,
    tolerance: float,
    max_iterations: int,
    *,
    rayleigh_alpha: float,
    rayleigh_beta: float,
    newmark_beta: float = 0.25,
    newmark_gamma: float = 0.5,
    warm_start: bool = True,
    warm_start_policy: str = "predictor",
    solver_variant: str = "auto",
    solver_replace_every: int = 10,
    reduction_precision: str = "fp64",
    vector_precision: str = "fp32",
    preconditioner=None,
) -> StepOut:
    """One implicit Newmark frame on the model's device.

    ``vector_precision`` is the YAML ``precision.vectors`` knob: "fp32" is
    the production contract, "fp64" the accuracy/debug mode (on CUDA the f64
    instances of K1/K5, K3, K7 and G1; K2, K4, K6 and G2 are f32 only, so
    'auto' is classic there, as in the reference).  ``solver_replace_every`` is the
    pipelined variant's residual-replacement period (``solver.replace_every``).
    """
    vdt = torch.float64 if vector_precision == "fp64" else torch.float32
    sc = np.float64 if vector_precision == "fp64" else np.float32
    dt = float(dt)
    if state.displacement.dtype != vdt:
        state = SimState(
            *(v.to(vdt) for v in (
                state.displacement, state.velocity,
                state.acceleration, state.warm_x,
            ))
        )
    external_force = external_force.to(vdt)

    # coefficients (newmark.cpp:34-47) in f64 host scalars
    beta, gamma = newmark_beta, newmark_gamma
    a0 = 1.0 / (beta * dt * dt)
    a1 = gamma / (beta * dt)
    a2 = 1.0 / (beta * dt)
    a3 = (1.0 / (2.0 * beta)) - 1.0
    a4 = (gamma / beta) - 1.0
    a5 = dt * ((gamma / (2.0 * beta)) - 1.0)

    stiffness_scale = sc(1.0 + a1 * rayleigh_beta)
    mass_factor = sc(a0 + a1 * rayleigh_alpha)

    def s(value) -> float:  # f64 -> vector-precision scalar, explicitly
        return float(sc(value))

    u = state.displacement
    v = state.velocity
    acc = state.acceleration

    # predictor from the pre-step state (newmark_stepper.cpp:1245-1286)
    with scope("newmark_predictor"):
        u_pred = u + s(dt) * v + s((0.5 - beta) * dt * dt) * acc
        v_pred = v + s((1.0 - gamma) * dt) * acc

    with scope("effective_rhs"):
        # effective RHS from the pre-step state (newmark_stepper.cpp:1162-1217)
        mass = model.mass_b
        mass_term = mass * (s(a0) * u + s(a2) * v + s(a3) * acc)
        damping_rhs = s(a1) * u + s(a4) * v + s(a5) * acc
        rhs = external_force + mass_term + s(rayleigh_alpha) * mass * damping_rhs
        if rayleigh_beta != 0.0:
            # stiffness-only operator (identity rows on constrained axes, as the
            # reference adds beta_R * (K * damping_rhs) verbatim)
            damping_output = model.apply_keff(damping_rhs, sc(1.0), sc(0.0))
            rhs = rhs + s(rayleigh_beta) * damping_output
        # Lysmer-Kuhlemeyer dashpots: a damping matrix C enters as rhs += C
        # (a1 u + a4 v + a5 a) and K_eff += a1 C, the algebra of the Rayleigh
        # terms; the preconditioner stays free of C, as in the reference.  The
        # structured route tags faces, the general path packs node blocks
        if getattr(model, "absorb_faces", ()) or getattr(model, "has_damping", False):
            rhs = rhs + model.absorbing_force(damping_rhs)
            model = dataclasses.replace(model, damp_factor=s(a1))

        # Dirichlet RHS clamp: the total-displacement Newmark form, so the
        # constrained solution component is the target itself
        rhs = torch.where(model.bc_mask, model.bc_value.to(vdt), rhs)

    # warm-start seed: "predictor" (default), "delta" (u_pred + previous
    # correction) or "solution" (reference parity)
    if warm_start_policy == "delta":
        x_seed = u_pred + state.warm_x
    elif warm_start_policy == "predictor":
        x_seed = u_pred
    else:
        x_seed = state.warm_x

    with scope("pcg_solve"):
        solution, pcg_telemetry = solve_pcg(
            model,
            rhs,
            stiffness_scale,
            mass_factor,
            tolerance,
            max_iterations,
            x_seed,
            warm_start=warm_start,
            reduction_dtype=(
                torch.float32 if reduction_precision == "fp32" else torch.float64
            ),
            vector_dtype=vdt,
            preconditioner=preconditioner,
            variant=solver_variant,
            replace_every=solver_replace_every,
        )

    # state update (newmark_stepper.cpp:1288-1314) with delta = x - u_pred
    with scope("newmark_update"):
        delta = solution - u_pred
        new_state = SimState(
            displacement=u_pred + delta,
            velocity=v_pred + s(gamma / (beta * dt)) * delta,
            acceleration=s(1.0 / (beta * dt * dt)) * delta,
            warm_x=delta if warm_start_policy == "delta" else solution,
        )
    return StepOut(state=new_state, pcg=pcg_telemetry)


class NewmarkStepper:
    """Host orchestration: one frame per ``step`` + the adaptive dt policy.

    Mirrors cwf::gpu::newmark::Stepper (newmark_stepper.hpp:92-190): grow dt
    x1.1 when iterations <= 0.3 * max, halve when non-converged, clamp to
    [min_dt, max_dt] (newmark_stepper.cpp:1328-1367).
    """

    def __init__(
        self,
        model,
        initial_state: SimState,
        external_force: torch.Tensor,
        rayleigh: RayleighCoefficients,
        solver_settings: SolverSettings,
        time_settings: TimeSettings,
        adaptive_policy: AdaptivePolicy = AdaptivePolicy(),
        newmark_beta: float = 0.25,
        newmark_gamma: float = 0.5,
        warm_start: bool = True,
        reduction_precision: str = "fp64",
        vector_precision: str = "fp32",
        warm_start_policy: str | None = None,
        solver_variant: str | None = None,
    ) -> None:
        self.model = model
        self.state = initial_state
        self.external_force = external_force
        self.rayleigh = rayleigh
        self.solver_settings = solver_settings
        self.time_settings = time_settings
        self.adaptive_policy = adaptive_policy
        self.current_dt = (
            time_settings.initial_dt if time_settings.initial_dt > 0.0 else 1.0e-3
        )
        self.accumulated_time = 0.0
        self.frame_index = 0
        self.newmark_beta = newmark_beta
        self.newmark_gamma = newmark_gamma
        self.warm_start_enabled = warm_start
        self.reduction_precision = reduction_precision
        self.vector_precision = vector_precision
        self.warm_start_policy = (
            warm_start_policy
            if warm_start_policy is not None
            else solver_settings.warm_start_policy
        )
        self.solver_variant = (
            solver_variant if solver_variant is not None
            else solver_settings.variant
        )
        # pipelined-variant residual-replacement period (YAML
        # solver.replace_every; 0 disables)
        self.solver_replace_every = solver_settings.replace_every
        # preconditioner hoisting: the build depends on dt only (through
        # the K_eff scalars), so it is reused across frames and rebuilt when
        # dt changes (the reference's ADR-17)
        self._precond = None
        self._precond_dt = None

    @property
    def node_count(self) -> int:
        return self.model.node_count

    @property
    def dof_count(self) -> int:
        return self.model.dof_count

    def pcg_variant(self) -> str:
        """The PCG variant this stepper's solves run: ``solver_variant``,
        'auto' resolved as ``solver.pcg.solve_pcg`` resolves it."""
        return resolve_variant(self.model, self.solver_variant, self._precond,
                               self._vector_dtype())

    def set_external_force(self, external_force: torch.Tensor) -> None:
        self.external_force = external_force

    def step(self, simulation_time_seconds: float, paused_mode: bool = False) -> StepTelemetry:
        """Run one frame (newmark_stepper.cpp:1094-1160)."""
        self.accumulated_time = simulation_time_seconds
        tolerance = (
            self.solver_settings.pause_tolerance
            if paused_mode
            else self.solver_settings.runtime_tolerance
        )
        if self._precond_dt != self.current_dt:
            with scope("pc_build"):
                ss, mf = effective_scalars(
                    self.current_dt,
                    self.rayleigh.alpha,
                    self.rayleigh.beta,
                    self.newmark_beta,
                    self.newmark_gamma,
                    vector_precision=self.vector_precision,
                )
                self._precond = self.model.build_preconditioner(ss, mf)
                self._precond_dt = self.current_dt
        out = newmark_step(
            self.model,
            self.state,
            self.external_force,
            self.current_dt,
            tolerance,
            int(self.solver_settings.max_iterations),
            rayleigh_alpha=self.rayleigh.alpha,
            rayleigh_beta=self.rayleigh.beta,
            newmark_beta=self.newmark_beta,
            newmark_gamma=self.newmark_gamma,
            warm_start=self.warm_start_enabled,
            warm_start_policy=self.warm_start_policy,
            solver_variant=self.solver_variant,
            solver_replace_every=self.solver_replace_every,
            reduction_precision=self.reduction_precision,
            vector_precision=self.vector_precision,
            preconditioner=self._precond,
        )
        self.state = out.state
        pcg = out.pcg
        with scope("telemetry_read"):
            residual, rhs_norm, alpha_last, beta_last = profiling.to_host(
                torch.stack([pcg.residual_norm, pcg.rhs_norm, pcg.alpha_last,
                             pcg.beta_last])
            ).tolist()

            telemetry = StepTelemetry(
                simulation_time=simulation_time_seconds,
                time_step=self.current_dt,
                applied_tolerance=tolerance,
                paused_mode=paused_mode,
                pcg_iterations=pcg.iterations,
                pcg_residual_norm=residual,
                pcg_rhs_norm=rhs_norm,
                pcg_alpha_last=alpha_last,
                pcg_beta_last=beta_last,
                pcg_converged=pcg.converged,
                pcg_breakdown=pcg.breakdown,
            )
            self._adapt_timestep(telemetry)
            self.frame_index += 1
            self.accumulated_time = simulation_time_seconds + self.current_dt
        return telemetry

    def _adapt_timestep(self, telemetry: StepTelemetry) -> None:
        """Grow/shrink/clamp dt (newmark_stepper.cpp:1328-1367)."""
        if not self.time_settings.adaptive:
            return
        threshold = self.adaptive_policy.low_iteration_ratio * float(
            self.solver_settings.max_iterations
        )
        if telemetry.pcg_iterations <= threshold:
            self.current_dt *= self.adaptive_policy.increase_factor
            telemetry.dt_increased = True
        elif not telemetry.pcg_converged:
            self.current_dt *= self.adaptive_policy.decrease_factor
            telemetry.dt_decreased = True
        if self.time_settings.min_dt > 0.0 and self.current_dt <= self.time_settings.min_dt:
            self.current_dt = self.time_settings.min_dt
            telemetry.dt_clamped_min = True
        if self.time_settings.max_dt > 0.0 and self.current_dt >= self.time_settings.max_dt:
            self.current_dt = self.time_settings.max_dt
            telemetry.dt_clamped_max = True

    # --- checkpoint / resume (utils/checkpoint.py; the reference's
    # stepper.py:426-442) --------------------------------------------------
    # What carries across frames: the state, dt, the clock and the frame
    # index, which a checkpoint saves.  The preconditioner is a function
    # of dt (rebuilt on the first step after a restore, _precond_dt being
    # None), the external force is the scenario's at the restored clock
    # (Simulation.run sets it before every frame > 0 of a curved load),
    # and the model's damp_factor is set per step.
    def _vector_dtype(self) -> torch.dtype:
        return torch.float64 if self.vector_precision == "fp64" else torch.float32

    def _shard(self):
        """The model's shard group, or None unsharded."""
        return getattr(self.model, "shard_group", None)

    def save_checkpoint(self, manager, wait: bool = False) -> None:
        """Save state, dt, clock and frame in ``manager`` (a
        ``utils.checkpoint.CheckpointManager``), the vectors in the run's
        precision (the f32 zero state of an fp64 run before its first frame
        widens exactly).  On a shard a collective: the four vectors are
        gathered to rank 0, which writes one file of the padded global
        model, the format of an unsharded run; the other ranks write
        nothing, and the group meets at a barrier."""
        vdt = self._vector_dtype()
        fields = (self.state.displacement, self.state.velocity,
                  self.state.acceleration, self.state.warm_x)
        group = self._shard()
        if group is not None:
            from ..parallel.sharding import gather

            fields = [gather(self.model, v, dst=0) for v in fields]
        if group is None or group.rank == 0:
            manager.save(self.frame_index, SimState(*(v.to(vdt) for v in fields)),
                         self.current_dt, self.accumulated_time, wait=wait)
        if group is not None:
            torch.distributed.barrier()

    def restore_checkpoint(self, manager, step: int | None = None) -> int:
        """Restore state/dt/clock/frame; returns the restored frame index.
        Raises CwfError when the checkpoint's vectors are not this model's
        layout and precision.  On a shard a collective: rank 0's write in
        flight is joined, then every rank reads the one file of global
        vectors and keeps its block (structured) or its rows (general)."""
        group = self._shard()
        if group is None:
            restored = manager.restore(step, model=self.model,
                                       dtype=self._vector_dtype())
        else:
            if group.rank == 0:
                manager.wait()
            torch.distributed.barrier()
            restored = manager.restore(step, shape=self._global_vector_shape(),
                                       dtype=self._vector_dtype())
            state = restored[0]
            restored = (SimState(*(self._own(getattr(state, f.name))
                                   for f in dataclasses.fields(state))),
                        *restored[1:])
        state, current_dt, accumulated_time, frame_index = restored
        self.state = state
        self.current_dt = current_dt
        self.accumulated_time = accumulated_time
        self.frame_index = frame_index
        return frame_index

    def _global_vector_shape(self):
        """A shard's vectors' shape on the whole (padded) model."""
        model = self.model
        if hasattr(model, "global_grid_shape"):
            return (3, *model.global_grid_shape)
        return (model.padded_node_count, 3)

    def _own(self, vector: torch.Tensor) -> torch.Tensor:
        """This shard's block or rows of a global host vector, on its
        device."""
        model = self.model
        if hasattr(model, "global_grid_shape"):
            from ..parallel.sharding import cut_block

            vector = cut_block(vector, model.x0, model.y0, *model.local_extent)
        else:
            vector = model.own_rows(vector)
        return vector.to(model.device)

    # --- host views of the device state (unpadded nodal rows) ------------
    # On a shard (a model with a ``shard_group``) each view gathers the
    # global vector first: a collective, so every rank of the group calls
    # it, and every rank gets the whole field (with ``dst``, that rank
    # only; the others get None).
    def _nodal(self, vector: torch.Tensor, dst: int | None = None):
        if self._shard() is not None:
            from ..parallel.sharding import gather

            vector = gather(self.model, vector, dst)
            if vector is None:
                return None
        return profiling.to_host(self.model.to_nodal(vector)).numpy()

    def host_kinematics(self, dst: int = 0):
        """(u, v, a) nodal rows on rank ``dst`` of a shard (None on the
        others; three gathers, a collective), or unsharded."""
        views = [self._nodal(v, dst) for v in (
            self.state.displacement, self.state.velocity,
            self.state.acceleration)]
        return None if views[0] is None else tuple(views)

    def displacement(self) -> np.ndarray:
        return self._nodal(self.state.displacement)

    def velocity(self) -> np.ndarray:
        return self._nodal(self.state.velocity)

    def acceleration(self) -> np.ndarray:
        return self._nodal(self.state.acceleration)
