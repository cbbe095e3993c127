"""Load-vector assembly: gravity, surface tractions, point loads, curves.

Port of :mod:`civiwave_tpu.physics.loads` (numpy host code, copied), a
rebuild of the reference engine's src/physics/loads.cpp:63-174.  Semantics:

* piecewise-linear curve evaluation clamps before the first and after the
  last point; degenerate (zero-span) segments return the *previous* value at
  the left edge (loads.cpp:63-85);
* gravity contributes ``lumped_mass * g`` per node (loads.cpp:93-100);
* tractions integrate over tri/quad faces with equal nodal shares, a quad
  being split into triangles (0,1,2) + (0,2,3) (loads.cpp:104-149);
* point loads add ``scale * value`` to every node in the group
  (loads.cpp:151-171);
* missing groups are skipped silently (validation happens in preprocess).

The structured route builds its nodal traction grids in
``mesh/structured.py`` and uses only :func:`evaluate_curve`; the general
gather path assembles the whole vector with :func:`assemble_load_vector`.
"""

from __future__ import annotations

import numpy as np

from ..config.schema import Config, Curve
from ..mesh.model import Mesh
from ..mesh.preprocess import PreprocessOutputs


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


def _curve_factor(cfg: Config, name: str, time: float) -> float:
    if not name:
        return 1.0
    curve = cfg.curves.get(name)
    if curve is None:
        return 1.0
    return evaluate_curve(curve, time)


def assemble_load_vector(
    mesh: Mesh, cfg: Config, preprocess: PreprocessOutputs, time: float
) -> np.ndarray:
    """Nodal load vector at ``time`` as (N, 3) float64 (loads.cpp:87-174)."""
    n = mesh.node_count
    loads = np.zeros((n, 3), dtype=np.float64)

    # gravity x lumped mass (loads.cpp:93-100)
    gravity = np.asarray(cfg.loads.gravity, dtype=np.float64)
    loads += preprocess.lumped_mass[:, None] * gravity[None, :]

    name_to_group = mesh.group_name_to_id()

    # surface tractions (loads.cpp:104-149)
    for traction in cfg.loads.tractions:
        group_id = name_to_group.get(traction.group)
        if group_id is None:
            continue
        surface_indices = mesh.surface_groups.get(group_id)
        if surface_indices is None:
            continue
        scale = _curve_factor(cfg, traction.scale_curve, time)
        value = np.asarray(traction.value, dtype=np.float64)

        conn = mesh.surfaces[surface_indices]
        counts = mesh.surface_node_counts[surface_indices]
        pos = mesh.node_positions

        def tri_area(i0, i1, i2):
            v1 = pos[i1] - pos[i0]
            v2 = pos[i2] - pos[i0]
            cr = np.cross(v1, v2)
            return 0.5 * np.sqrt(np.einsum("ij,ij->i", cr, cr))

        tri_mask = counts == 3
        quad_mask = counts == 4
        area = np.zeros(len(conn), dtype=np.float64)
        if tri_mask.any():
            c = conn[tri_mask]
            area[tri_mask] = tri_area(c[:, 0], c[:, 1], c[:, 2])
        if quad_mask.any():
            c = conn[quad_mask]
            area[quad_mask] = tri_area(c[:, 0], c[:, 1], c[:, 2]) + tri_area(
                c[:, 0], c[:, 2], c[:, 3]
            )
        nodal_share = area * scale / np.maximum(counts, 1)
        contribution = nodal_share[:, None] * value[None, :]  # (S, 3)
        for slot in range(4):
            active = counts > slot
            if active.any():
                np.add.at(loads, conn[active, slot], contribution[active])

    # point loads (loads.cpp:151-171)
    for point in cfg.loads.points:
        group_id = name_to_group.get(point.group)
        if group_id is None:
            continue
        node_indices = mesh.node_groups.get(group_id)
        if node_indices is None:
            continue
        scale = _curve_factor(cfg, point.scale_curve, time)
        value = np.asarray(point.value, dtype=np.float64) * scale
        np.add.at(loads, node_indices, value[None, :])

    return loads
