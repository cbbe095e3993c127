"""Route eligible scenarios onto the structured-grid route.

Port of :mod:`civiwave_tpu.mesh.structured_config`.  A scenario maps onto
:class:`~civiwave_tpu_torch.mesh.structured.StructuredModel` when it is a
``synthetic://box`` hex mesh with one material, or with ``box_regions``
that say where each material lies, and loads/fixes on the box's axis
planes (FIXED = x0, LOAD_FACE = x1, SIDE_* faces).  Anything else returns
None and takes the general gather path (``mesh/pack.py``).

With ``box_regions`` the ``assignments`` bind each cell's group (``SOLID``
or its region, ``utils.synthetic.box_cell_groups``) to a material, as
``preprocess.bind_materials`` binds the same groups of the box mesh on the
general path.  Where the bound materials differ between cells, per-cell
lam, mu (f32, ``physics.materials.make_properties``) and rho are built on
the device (the set-up phase ``materials`` of ``utils.profiling``) and the
grid is heterogeneous: G3, the per-node block-Jacobi, classic PCG.  One
bound material builds the homogeneous grid of that material, bit for bit
the grid of a scenario without regions.  The model's ``material_cells``
counts the cells of each bound material.

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

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config.loader import BOX_GROUPS, BOX_PREFIX
from ..config.schema import Config, Curve
from ..physics import loads as loads_mod
from ..physics import materials
from ..utils import profiling
from ..utils.errors import PreprocessError
from ..utils.synthetic import box_cell_groups
from .structured import StructuredModel, build_structured_model, traction_force_grid

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
    if len(cfg.materials) != 1 and not cfg.box_regions:
        return None  # no place for each material without regions
    if cfg.loads.points:
        return None  # the box mesh defines no node groups
    if any(t.group not in _PLANE_OF_GROUP for t in cfg.loads.tractions):
        return None
    if any(f.group not in _PLANE_OF_GROUP for f in cfg.dirichlet):
        return None
    if any(g not in _PLANE_OF_GROUP for g in cfg.absorbing):
        return None
    material, grids = cfg.materials[0], {}
    material_cells = ((material.name, nx * ny * nz),)
    if cfg.box_regions:
        with profiling.phase("materials", device):
            index = cell_material_index(cfg, nx, ny, nz, device)
            counts = torch.bincount(
                index.reshape(-1), minlength=len(cfg.materials)).tolist()
            material_cells = tuple((m.name, c) for m, c in
                                   zip(cfg.materials, counts) if c)
            material = cfg.materials[next(i for i, c in enumerate(counts) if c)]
            if len(material_cells) > 1:
                grids = cell_fields(cfg, index)
    fixes = [
        (_PLANE_OF_GROUP[f.group], f.constrain_axis, f.value)
        for f in cfg.dirichlet
    ]
    model, base = build_structured_model(
        nx, ny, nz, materials.make_properties(material), material.density,
        spacing=(spacing, spacing, spacing),
        fixes=fixes,
        gravity=cfg.loads.gravity,
        pad_x_multiple=pad_x_multiple,
        pad_y_multiple=pad_y_multiple,
        absorb_planes=tuple(_PLANE_OF_GROUP[g] for g in cfg.absorbing),
        device=device,
        **grids,
    )
    model = dataclasses.replace(model, material_cells=material_cells)
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


def cell_material_index(cfg: Config, nx: int, ny: int, nz: int, device) -> torch.Tensor:
    """(nx, ny, nz) int64 on ``device``: per cell the index into
    ``cfg.materials`` that ``assignments`` bind to its group (``SOLID`` or
    its box region; a later assignment of a group wins, as in
    ``preprocess.bind_materials``).  An assignment of a group the box does
    not have, or a group that holds cells and no assignment, raises
    PreprocessError."""
    names = ["SOLID"] + [r.group for r in cfg.box_regions]
    groups = box_cell_groups(cfg.box_regions, nx, ny, nz, device)
    material_names = [m.name for m in cfg.materials]
    bound = {}
    for i, a in enumerate(cfg.assignments):
        if a.group not in names and a.group not in BOX_GROUPS:
            raise PreprocessError(
                f"assignment references missing physical group '{a.group}'",
                ["assignments", f"[{i}]"],
            )
        bound[a.group] = material_names.index(a.material)
    present = torch.bincount(groups.reshape(-1), minlength=len(names)).tolist()
    for name, cells in zip(names, present):
        if cells and name not in bound:
            raise PreprocessError(
                f"box group '{name}' holds {cells} cells and no assignment",
                ["assignments"],
            )
    lut = torch.tensor([bound.get(name, 0) for name in names], device=device)
    return lut[groups]


def cell_fields(cfg: Config, index: torch.Tensor) -> dict:
    """``build_structured_model``'s per-cell ``lam_grid``, ``mu_grid``
    (f32) and ``rho_grid`` (f64) of the material ``index`` of each cell."""
    props = [materials.make_properties(m) for m in cfg.materials]

    def field(values, dtype):
        return torch.tensor(values, dtype=dtype, device=index.device)[index]

    return dict(
        lam_grid=field([p.lame.lam for p in props], torch.float32),
        mu_grid=field([p.lame.mu for p in props], torch.float32),
        rho_grid=field([m.density for m in cfg.materials], torch.float64),
    )
