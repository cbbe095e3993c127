"""Newmark-beta (average acceleration) algebra — host/oracle side.

Copy of :mod:`civiwave_tpu.physics.newmark` (a rebuild of the reference
engine's src/physics/newmark.cpp:34-156).  These are the closed forms the
device stepper (``solver/stepper.py``) re-derives; the dense oracle
(``physics/oracle.py``) steps with them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .materials import RayleighCoefficients


@dataclass(frozen=True)
class Coefficients:
    """a0..a5 + (beta, gamma, dt) (newmark.cpp:34-47)."""

    beta: float
    gamma: float
    dt: float
    a0: float
    a1: float
    a2: float
    a3: float
    a4: float
    a5: float


@dataclass
class State:
    """Flat (dof,) float64 kinematic state."""

    displacement: np.ndarray
    velocity: np.ndarray
    acceleration: np.ndarray

    @staticmethod
    def zeros(dof_count: int) -> "State":
        return State(
            np.zeros(dof_count), np.zeros(dof_count), np.zeros(dof_count)
        )


@dataclass(frozen=True)
class UpdateScalars:
    """1/(beta dt^2) and gamma/(beta dt) (newmark.cpp:73-81)."""

    inv_beta_dt2: float
    gamma_over_beta_dt: float


def make_coefficients(dt: float, beta: float = 0.25, gamma: float = 0.5) -> Coefficients:
    return Coefficients(
        beta=beta,
        gamma=gamma,
        dt=dt,
        a0=1.0 / (beta * dt * dt),
        a1=gamma / (beta * dt),
        a2=1.0 / (beta * dt),
        a3=(1.0 / (2.0 * beta)) - 1.0,
        a4=(gamma / beta) - 1.0,
        a5=dt * ((gamma / (2.0 * beta)) - 1.0),
    )


def predict_state(coeffs: Coefficients, previous: State):
    """Explicit predictor (newmark.cpp:49-71)."""
    dt = coeffs.dt
    disp_factor = 0.5 - coeffs.beta
    vel_factor = 1.0 - coeffs.gamma
    u_pred = (
        previous.displacement
        + dt * previous.velocity
        + dt * dt * disp_factor * previous.acceleration
    )
    v_pred = previous.velocity + dt * vel_factor * previous.acceleration
    return u_pred, v_pred


def compute_update_scalars(coeffs: Coefficients) -> UpdateScalars:
    return UpdateScalars(
        inv_beta_dt2=1.0 / (coeffs.beta * coeffs.dt * coeffs.dt),
        gamma_over_beta_dt=coeffs.gamma / (coeffs.beta * coeffs.dt),
    )


def build_effective_stiffness(
    stiffness: np.ndarray,
    mass_diag: np.ndarray,
    rayleigh: RayleighCoefficients,
    coeffs: Coefficients,
) -> np.ndarray:
    """K_eff = (1 + a1 beta_R) K + (a0 + a1 alpha_R) M (newmark.cpp:83-100)."""
    stiffness_scale = 1.0 + coeffs.a1 * rayleigh.beta
    mass_factor = coeffs.a0 + coeffs.a1 * rayleigh.alpha
    keff = stiffness * stiffness_scale
    keff[np.diag_indices_from(keff)] += mass_diag * mass_factor
    return keff


def build_effective_rhs(
    external_load: np.ndarray,
    stiffness: np.ndarray,
    mass_diag: np.ndarray,
    rayleigh: RayleighCoefficients,
    coeffs: Coefficients,
    state: State,
) -> np.ndarray:
    """Effective force with mass + Rayleigh terms (newmark.cpp:102-133)."""
    u, v, a = state.displacement, state.velocity, state.acceleration
    mass_term = mass_diag * (coeffs.a0 * u + coeffs.a2 * v + coeffs.a3 * a)
    damping_rhs = coeffs.a1 * u + coeffs.a4 * v + coeffs.a5 * a
    rhs = external_load + mass_term + rayleigh.alpha * mass_diag * damping_rhs
    if rayleigh.beta != 0.0:
        rhs = rhs + rayleigh.beta * (stiffness @ damping_rhs)
    return rhs


def update_state(
    coeffs: Coefficients, previous: State, delta_displacement: np.ndarray
) -> State:
    """Kinematic update from the displacement increment (newmark.cpp:135-156)."""
    du = delta_displacement
    acceleration = (
        coeffs.a0 * du - coeffs.a2 * previous.velocity - coeffs.a3 * previous.acceleration
    )
    velocity = previous.velocity + coeffs.dt * (
        (1.0 - coeffs.gamma) * previous.acceleration + coeffs.gamma * acceleration
    )
    return State(
        displacement=previous.displacement + du,
        velocity=velocity,
        acceleration=acceleration,
    )
