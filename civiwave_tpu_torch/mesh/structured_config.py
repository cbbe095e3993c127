"""Route eligible scenarios onto the structured-grid route.

Port of :mod:`civiwave_tpu.mesh.structured_config`.  A scenario maps onto
:class:`~civiwave_tpu_torch.mesh.structured.StructuredModel` when it is a
``synthetic://box`` hex mesh with one material and loads/fixes on the box's
axis planes (FIXED = x0, LOAD_FACE = x1, SIDE_* faces).  Anything else
returns None and takes the general gather path (``mesh/pack.py``).

Time-curve-scaled tractions keep each curved traction's nodal force grid as
a separate device tensor: the per-frame force is
``base + sum_i curve_i(t) * part_i``.

Absorbing groups (``boundaries.absorbing``) on the box's axis planes become
the model's Lysmer-Kuhlemeyer faces.  ``solver.preconditioner: multigrid``
attaches the geometric multigrid hierarchy (``ops/multigrid.py``).  fp64
solver vectors run on either device: on CUDA through the f64 instances of
K1/K5 and K3.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config.schema import Config, Curve
from ..physics import loads as loads_mod
from ..physics import materials
from .structured import StructuredModel, build_structured_model, traction_force_grid

BOX_PREFIX = "synthetic://box/"

# the synthetic box mesh's physical groups sit on these axis planes
_PLANE_OF_GROUP = {
    "FIXED": "x0", "LOAD_FACE": "x1",
    "SIDE_X0": "x0", "SIDE_X1": "x1",
    "SIDE_Y0": "y0", "SIDE_Y1": "y1",
    "SIDE_Z0": "z0", "SIDE_Z1": "z1",
}


def parse_box_spec(mesh_path: str) -> Tuple[int, int, int, bool, float]:
    """``synthetic://box/nx,ny,nz[,tet|hex][,spacing]`` -> components."""
    spec = mesh_path[len(BOX_PREFIX):].split(",")
    nx, ny, nz = int(spec[0]), int(spec[1]), int(spec[2])
    hex_elements = "tet" not in spec[3:]
    spacing = next(
        (float(s) for s in spec[3:] if s.replace(".", "", 1).isdigit()), 1.0
    )
    return nx, ny, nz, hex_elements, spacing


@dataclass
class StructuredForceSchedule:
    """Base force + per-curve traction parts, combined on device per frame."""

    base: torch.Tensor  # (3, X, Y, Z) f32
    curve_parts: List[Tuple[str, torch.Tensor]]

    def at_time(self, curves: Dict[str, Curve], t: float) -> torch.Tensor:
        force = self.base
        for name, part in self.curve_parts:
            scale = loads_mod.evaluate_curve(curves[name], t)
            force = force + float(np.float32(scale)) * part
        return force


def try_build_structured(
    cfg: Config, pad_x_multiple: int = 1, *, device, pad_y_multiple: int = 1,
) -> Optional[Tuple[StructuredModel, StructuredForceSchedule]]:
    """(model, force schedule) on ``device`` when the scenario fits the
    structured route, else None.  The pad multiples add dead +X planes and
    +Y rows so the grid divides a shard group."""
    if not cfg.mesh_path.startswith(BOX_PREFIX):
        return None
    nx, ny, nz, hex_elements, spacing = parse_box_spec(cfg.mesh_path)
    if not hex_elements:
        return None
    if len(cfg.materials) != 1:
        return None  # constant stencil needs a homogeneous grid
    if cfg.loads.points:
        return None  # the box mesh defines no node groups
    if any(t.group not in _PLANE_OF_GROUP for t in cfg.loads.tractions):
        return None
    if any(f.group not in _PLANE_OF_GROUP for f in cfg.dirichlet):
        return None
    if any(g not in _PLANE_OF_GROUP for g in cfg.absorbing):
        return None
    props = materials.make_properties(cfg.materials[0])
    fixes = [
        (_PLANE_OF_GROUP[f.group], f.constrain_axis, f.value)
        for f in cfg.dirichlet
    ]
    model, base = build_structured_model(
        nx, ny, nz, props, cfg.materials[0].density,
        spacing=(spacing, spacing, spacing),
        fixes=fixes,
        gravity=cfg.loads.gravity,
        pad_x_multiple=pad_x_multiple,
        pad_y_multiple=pad_y_multiple,
        absorb_planes=tuple(_PLANE_OF_GROUP[g] for g in cfg.absorbing),
        device=device,
    )
    curve_parts: List[Tuple[str, torch.Tensor]] = []
    for t in cfg.loads.tractions:
        part = torch.as_tensor(
            traction_force_grid(model, _PLANE_OF_GROUP[t.group], t.value),
            device=model.device,
        )
        if t.scale_curve:
            curve_parts.append((t.scale_curve, part))
        else:
            base = base + part
    if cfg.solver.preconditioner == "multigrid":
        from ..ops.multigrid import attach_multigrid

        model = attach_multigrid(model)
    return model, StructuredForceSchedule(base=base, curve_parts=curve_parts)
