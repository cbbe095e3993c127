"""Load helpers of the structured route.

Port of :mod:`civiwave_tpu.physics.loads`, cut to what the structured
route uses: piecewise-linear curve evaluation (loads.cpp:63-85 in the
reference).  The structured route builds its nodal traction grids in
``mesh/structured.py``; the general-path load-vector assembly
(``assemble_load_vector``) waits for the general-path port (ROADMAP A6).
"""

from __future__ import annotations

from ..config.schema import Curve


def evaluate_curve(curve: Curve, time: float) -> float:
    """Clamped piecewise-linear evaluation (loads.cpp:63-85)."""
    points = curve.points
    if len(points) == 0:
        return 1.0
    if time <= points[0][0]:
        return points[0][1]
    for i in range(1, len(points)):
        prev_t, prev_v = points[i - 1]
        cur_t, cur_v = points[i]
        if time <= cur_t:
            span = cur_t - prev_t
            weight = (time - prev_t) / span if span > 0.0 else 0.0
            return prev_v + (cur_v - prev_v) * weight
    return points[-1][1]
