"""Interactive solve session: the viewer's simulation backend, headless.

Port of :mod:`civiwave_tpu.ui.session`, a rebuild of the reference
engine's ``SimulationBackend`` (src/ui/viewer.cpp:187-360): it captures a
baseline of the kinematic state and the external force once, and every
interactive solve (1) restores that baseline, (2) optionally injects a
point load at an anchor node — direction safe-normalized with a -Z
fallback for degenerate input, scaled by the requested magnitude in
newtons (apply_custom_load, viewer.cpp:318-340) — (3) advances one Newmark
frame on the simulation's device, and (4) recomputes the derived fields
for coloring (on the device on the structured route, from the host mesh
on the general path).  The GLFW/ImGui shell is out of scope; pair this
with :mod:`civiwave_tpu_torch.post.snapshot`, the web viewer
(``ui/viewer.py``) or ParaView via the VTU output.

The reference's baseline is a set of immutable arrays.  The port's loops
may write their vectors in place (the megafused loop updates x, u and p,
and with ``warm_start_policy: solution`` x starts as ``state.warm_x``
itself), so the session owns clones of the baseline state and force and
every :meth:`InteractiveSession.reset` hands the stepper fresh clones of
them: two equal requests give bit-equal states on every PCG variant.  The
structured route builds no host mesh here (its derived fields come from
the device grids), so a session on a 50M-DOF grid stays on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..mesh.pack import SimState
from ..physics import materials as materials_mod
from ..post.derived import DerivedFieldSet, compute_derived_fields
from ..solver.stepper import StepTelemetry
from ..utils import profiling
from ..utils.vec3 import magnitude, safe_normalize

_FIELDS = ("displacement", "velocity", "acceleration", "warm_x")


def _clone(state: SimState) -> SimState:
    return SimState(*(getattr(state, f).clone() for f in _FIELDS))


@dataclass
class PointLoadRequest:
    """Interactive load (StressVectorRequest, viewer.cpp:880-900)."""

    enabled: bool = False
    anchor: int = 0
    direction: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    magnitude_newtons: float = 0.0


class InteractiveSession:
    """Baseline-capturing interactive wrapper around a Simulation."""

    def __init__(self, simulation) -> None:
        self._sim = simulation
        self._structured = bool(getattr(simulation, "structured", False))
        # the general path's derived-field recompute reads the host mesh;
        # the structured route's runs on the device grids
        if not self._structured and getattr(simulation, "mesh", None) is None:
            simulation.ensure_host_mesh()
        self._stepper = simulation.stepper
        self._model = simulation.model
        # baseline snapshot (capture_baseline_state, viewer.cpp:283-290),
        # cloned: the loops may write the stepper's vectors in place
        self._baseline_state = _clone(self._stepper.state)
        self._baseline_force = self._stepper.external_force.clone()
        self._baseline_time = self._stepper.accumulated_time
        self._baseline_dt = self._stepper.current_dt
        mats = [
            materials_mod.make_properties(m)
            for m in simulation.config.materials
        ]
        _, _, self._d_all = materials_mod.material_tables(mats)

    def reset(self) -> None:
        """Restore the baseline state/force (restore_node_state +
        restore_external_force, viewer.cpp:292-318): fresh clones of the
        captured ones."""
        self._stepper.state = _clone(self._baseline_state)
        self._stepper.external_force = self._baseline_force.clone()
        self._stepper.accumulated_time = self._baseline_time
        self._stepper.current_dt = self._baseline_dt

    def _inject_point_load(self, request: PointLoadRequest):
        """apply_custom_load (viewer.cpp:318-340): normalize the direction
        (fallback -Z for degenerate input), add magnitude * direction at
        the clamped anchor node."""
        node = min(max(int(request.anchor), 0), self._model.node_count - 1)
        direction = np.asarray(request.direction, np.float64)
        if magnitude(direction) < 1.0e-6:
            direction = np.array([0.0, 0.0, -1.0])
        else:
            direction = safe_normalize(direction)
        load = (direction * request.magnitude_newtons).astype(np.float32)

        rows = profiling.to_host(self._model.to_nodal(self._baseline_force)).numpy()
        rows = rows.astype(np.float32)
        rows[node] += load
        return self._model.from_nodal(rows).to(self._baseline_force.dtype)

    def solve(
        self,
        request: Optional[PointLoadRequest] = None,
        paused_mode: bool = False,
    ) -> Tuple[StepTelemetry, DerivedFieldSet]:
        """One interactive frame from the baseline (SimulationBackend::
        solve, viewer.cpp:255-278): restore, inject, step, derive."""
        self.reset()
        if request is not None and request.enabled:
            self._stepper.external_force = self._inject_point_load(request)

        telemetry = self._stepper.step(
            self._stepper.accumulated_time, paused_mode
        )
        if self._structured:
            # device-side derived fields (post/structured_fields.py) keep
            # the interactive loop at viewer rates on large grids
            from ..post.structured_fields import (
                compute_structured_derived,
                derived_to_host,
            )

            derived = derived_to_host(
                self._model,
                compute_structured_derived(
                    self._model, self._stepper.state.displacement
                ),
            )
        else:
            derived = compute_derived_fields(
                self._sim.preprocess,
                self._d_all,
                self._stepper.displacement(),
                self._sim.mesh.node_count,
                self._sim.mesh.element_count,
            )
        return telemetry, derived


# ---------------------------------------------------------------------------
# directional display-stress overlay (viewer.cpp:2940-2999, 3290-3321)
# ---------------------------------------------------------------------------


def stress_reference_range(base_stress: np.ndarray) -> float:
    """Reference scale of the base von Mises field
    (refresh_stress_reference_range, viewer.cpp:3290-3321)."""
    base = np.asarray(base_stress, np.float64)
    finite = base[np.isfinite(base)]
    if finite.size == 0:
        return 1.0
    min_v, max_v = float(finite.min()), float(finite.max())
    delta = max_v - min_v
    fallback = max(abs(max_v), 1.0)
    return max(abs(delta), max(fallback, 1.0e-3))


def estimate_auto_falloff(
    positions: np.ndarray, base_stress: np.ndarray, anchor: int
) -> float:
    """Decay constant (1/m) from the local stress gradients around the
    anchor (estimate_auto_falloff, viewer.cpp:3324-3365): mean
    |sigma_i - sigma_anchor| / distance over all vertices, normalized by
    the anchor stress and clamped to [0.05, 2.0]; 0.35 default."""
    positions = np.asarray(positions, np.float64)
    base = np.asarray(base_stress, np.float64)
    if positions.shape[0] == 0 or base.size == 0:
        return 0.35
    anchor = min(max(int(anchor), 0), positions.shape[0] - 1)
    anchor_stress = max(abs(float(base[anchor])), 1.0e-3)
    delta = positions - positions[anchor]
    dist = np.sqrt(np.einsum("ij,ij->i", delta, delta))
    dstress = np.abs(base - base[anchor])
    mask = (dist >= 1.0e-4) & (dstress >= 1.0e-6)
    mask[anchor] = False
    if not mask.any():
        return 0.35
    mean_gradient = float((dstress[mask] / dist[mask]).mean())
    return float(np.clip(mean_gradient / anchor_stress, 0.05, 2.0))


def display_stress_overlay(
    positions: np.ndarray,
    base_stress: np.ndarray,
    request: PointLoadRequest,
    magnitude_scale: float = 1.0,
):
    """Anticipatory directional stress overlay
    (recompute_display_stress, viewer.cpp:2940-2999).

    Paints an exponentially-decaying directional contribution from the
    picked anchor over the whole mesh on top of the solved von Mises
    field: vertices aligned with the load direction gain
    ``reference_scale * magnitude * alignment * exp(-distance * falloff)``
    with the falloff auto-derived from the local stress gradients.
    Returns (display (N,) f32, falloff).
    """
    positions = np.asarray(positions, np.float64)
    base = np.asarray(base_stress, np.float64)
    display = np.where(np.isfinite(base), base, 0.0)
    if magnitude_scale != 1.0:
        display = display * float(magnitude_scale)
    falloff = estimate_auto_falloff(positions, base, request.anchor)
    if (
        not request.enabled
        or positions.shape[0] == 0
        or int(request.anchor) >= base.size
    ):
        return display.astype(np.float32), falloff

    anchor = min(max(int(request.anchor), 0), positions.shape[0] - 1)
    direction = np.asarray(request.direction, np.float64)
    if magnitude(direction) < 1.0e-6:
        direction = np.array([0.0, 0.0, -1.0])
    else:
        direction = safe_normalize(direction)
    reference_scale = max(stress_reference_range(base), 1.0)
    scale = reference_scale * float(magnitude_scale)

    delta = positions - positions[anchor]
    dist = np.sqrt(np.einsum("ij,ij->i", delta, delta))
    near = dist < 1.0e-5
    with np.errstate(divide="ignore", invalid="ignore"):
        unit = delta / dist[:, None]
    alignment = unit @ direction
    influence = np.where(
        near,
        scale,
        np.where(
            alignment > 0.0,
            scale * alignment * np.exp(-dist * falloff),
            0.0,
        ),
    )
    return (display + influence).astype(np.float32), falloff
