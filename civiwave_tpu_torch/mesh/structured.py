"""Structured-grid route: uniform hex8 grids without gathers.

Port of :mod:`civiwave_tpu.mesh.structured`.  For an axis-aligned box of
(nx, ny, nz) uniform hex cells every element shares one constant Gauss
gradient table and connectivity is implicit, so on a homogeneous grid the
element-by-element matvec becomes a 27-point block stencil on the node grid
(see ``ops/structured.py``).  Per-cell materials (``lam_grid``/``mu_grid``
given to :func:`build_structured_model`) make a heterogeneous grid
(``homogeneous`` False), whose operator is the corner-gather element loop
and whose preconditioner is the per-node block-Jacobi inverse.

Solver vectors are component-separated grids ``(3, X, Y, Z)`` f32 with Z
the minor (contiguous) axis — the reference's layout, kept at the port's
public functions so parity tests compare like with like.  On the card Z is
also the fastest thread index of every kernel, so loads coalesce.

The model is a frozen dataclass of tensors on one device (the counterpart
of the JAX pytree); it holds no trainable parameters and nothing needs a
gradient.  One build path builds every grid with torch directly on the
target device.

Lysmer-Kuhlemeyer absorbing faces ride on the model as face tags and the
material's impedances; the stepper sets ``damp_factor`` (Newmark a1) on a
copy of the model per step.

Dead +X planes and dead +Y rows (``pad_x_multiple``/``pad_y_multiple``)
pad the grid to a multiple of a shard group's extents; they are fully
constrained and massless.  A shard of a multi-device decomposition
(``parallel.sharding.shard_structured``) is a StructuredModel too: its
node-grid fields are the shard's local slab or tile, ``grid_shape`` and
``vector_shape`` are local, and ``nx``/``ny``/``nz``, the node counts and
``position0`` stay global, as do the vectors of ``to_nodal``/``from_nodal``.

A multigrid model (``preconditioner == "multigrid"``, from
``ops.multigrid.attach_multigrid``) carries its coarse levels; its
preconditioner is the V-cycle and its PCG is classic ('auto') or
pipelined, composing the V-cycle with the operator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..physics.materials import ElasticProperties
from ..utils import profiling

# corner offsets in Gmsh hex ordering (matches preprocess._HEX_XI)
CORNERS = (
    (0, 0, 0),
    (1, 0, 0),
    (1, 1, 0),
    (0, 1, 0),
    (0, 0, 1),
    (1, 0, 1),
    (1, 1, 1),
    (0, 1, 1),
)


@dataclass(frozen=True, eq=False)
class StructuredModel:
    """Uniform hex grid implementing the solver operator protocol.

    Node grid is (X, Y, Z) = (nx+1+pad_planes, ny+1, nz+1); the nodal order
    of ``to_nodal``/``from_nodal`` is x-major flattening.
    """

    # per-element material fields, padded along X to the node extent
    # (dead tail cells are never read — consume through lam_cells/mu_cells)
    lam_grid: torch.Tensor  # (X, ny, nz) f32
    mu_grid: torch.Tensor  # (X, ny, nz) f32
    # node-grid fields (component-separated layout)
    mass_grid: torch.Tensor  # (X, Y, Z) f32
    bc_mask: torch.Tensor  # (3, X, Y, Z) bool
    bc_value: torch.Tensor  # (3, X, Y, Z) f32
    position0: torch.Tensor  # (N, 3) f32 — host-facing nodal coordinates
    # (27 classes, 27 offsets, 3, 3) f32 per-boundary-class assembled
    # stencil (ops.structured.class_stencil_table) read by the K1/K2
    # kernels; uploaded once per model
    stencil_table: torch.Tensor
    # host copy of its interior class (1, 1, 1) in factored form and the
    # z-face ghost taps at dz = 0 (ops.structured.sweep_taps): (192,) f32
    # numpy, passed by value to K1/K5, K2 and K6 at each launch (no device
    # read)
    sweep_taps: Optional[np.ndarray] = None
    nx: int = 0
    ny: int = 0
    nz: int = 0
    node_count: int = 0
    padded_node_count: int = 0
    # node planes along +X beyond nx+1 and node rows along +Y beyond ny+1:
    # dead (fully constrained, massless), so the grid divides a shard group
    pad_planes: int = 0
    pad_rows: int = 0
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # one material on every cell (lam0, mu0; the constant-stencil kernels);
    # False: per-cell lam_grid/mu_grid, the corner-gather operator and the
    # per-node block-Jacobi, lam0 = mu0 = 0.0 (the reference's rule)
    homogeneous: bool = True
    lam0: float = 0.0
    mu0: float = 0.0
    # interior lumped mass rho*V_cell; every built grid's stored mass is m8
    # times 0.5 per boundary axis, bit for bit, so the kernels synthesize
    # the mass instead of streaming the grid (see interior_mass); a
    # multigrid coarse level's is not, and carries mass_correction; NaN on
    # a grid of per-cell densities, which only mass_grid describes
    m8: float = 0.0
    # Lysmer-Kuhlemeyer absorbing axis planes ("x0".."z1") with viscous
    # dashpots of per-unit-area normal/tangential impedances rho*c_p /
    # rho*c_s; damp_factor is the Newmark a1 the stepper sets per step
    # (K_eff += a1 C; None: no term)
    absorb_faces: Tuple[str, ...] = ()
    rho_cp: float = 0.0
    rho_cs: float = 0.0
    damp_factor: Optional[float] = None
    # a shard (parallel.sharding.shard_structured): its group (a
    # parallel.sharding.ShardGroup), its node offsets (x0, y0) in the global
    # grid, its local node extents (Xl, Yl), the bc mask's ghost planes
    # and rows (an ops.structured_sharded.Ghosts of bool tensors) and, on a
    # heterogeneous grid, lam and mu of the cell plane and row below the
    # block (an ops.structured_sharded.CellGhosts), both exchanged once;
    # None and 0 on an unsharded model
    shard_group: Optional[object] = None
    x0: int = 0
    y0: int = 0
    local_extent: Optional[Tuple[int, int]] = None
    bc_ghosts: Optional[object] = None
    cell_ghosts: Optional[object] = None
    # geometric multigrid (ops.multigrid.attach_multigrid): the
    # preconditioner ("block_jacobi" or "multigrid"), the coarse levels
    # (StructuredModels of doubled spacing, finest first) and one smoother
    # damping per level, this one first; empty without a hierarchy
    preconditioner: str = "block_jacobi"
    mg_levels: Tuple["StructuredModel", ...] = ()
    mg_omegas: Tuple[float, ...] = ()
    # where mass_grid differs from the kernels' synthesized m8 masses (a
    # coarse level's P^T m_f): an ops.structured.MassCorrection the
    # operator adds after the kernels on CUDA; None on every built grid
    mass_correction: Optional[object] = None
    # cells per bound material, (name, cells) in the scenario's material
    # order (mesh.structured_config); empty on a grid built by API
    material_cells: Tuple[Tuple[str, int], ...] = ()

    @property
    def device(self) -> torch.device:
        return self.bc_mask.device

    @property
    def psum(self):
        """The shard group's all-reduce (PCG's reduction hook), or None on
        an unsharded model."""
        return None if self.shard_group is None else self.shard_group.psum

    @property
    def lam_cells(self) -> torch.Tensor:
        """(nx, ny, nz) live-cell view of the X-padded material grid."""
        return self.lam_grid[: self.nx, : self.ny]

    @property
    def mu_cells(self) -> torch.Tensor:
        return self.mu_grid[: self.nx, : self.ny]

    @property
    def global_grid_shape(self) -> Tuple[int, int, int]:
        return (
            self.nx + 1 + self.pad_planes,
            self.ny + 1 + self.pad_rows,
            self.nz + 1,
        )

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        """The node grid this model's tensors hold: a shard's local one."""
        if self.local_extent is None:
            return self.global_grid_shape
        return (*self.local_extent, self.nz + 1)

    @property
    def dof_count(self) -> int:
        return self.node_count * 3

    # --- operator protocol -------------------------------------------------
    @property
    def vector_shape(self) -> Tuple[int, ...]:
        return (3, *self.grid_shape)

    @property
    def mass_b(self) -> torch.Tensor:
        """Lumped mass broadcastable against solver vectors."""
        return self.mass_grid[None]

    def zero_state(self):
        from .pack import SimState

        z = torch.zeros(self.vector_shape, dtype=torch.float32, device=self.device)
        return SimState(z, z, z, z)

    def to_nodal(self, vector: torch.Tensor) -> torch.Tensor:
        """CSG vector of the global grid -> (node_count, 3) nodal rows
        (x-major order; the dead +Y rows are stripped first).  On a shard,
        gather the vector first (``parallel.sharding.gather_structured``)."""
        if self.pad_rows:  # dead Y rows interleave in x-major flat order
            vector = vector[:, :, : self.ny + 1]
        flat = vector.permute(1, 2, 3, 0).reshape(-1, 3)
        return flat[: self.node_count]

    def from_nodal(self, rows) -> torch.Tensor:
        """(node_count, 3) nodal rows -> CSG vector of the global grid (pad
        planes and dead rows zeroed)."""
        rows = profiling.from_host(rows, self.device)
        real = (self.nx + 1 + self.pad_planes, self.ny + 1, self.nz + 1)
        flat = torch.zeros(
            (int(np.prod(real)), 3), dtype=torch.float32, device=self.device,
        )
        flat[: self.node_count] = rows[: self.node_count]
        grid = flat.reshape(*real, 3).permute(3, 0, 1, 2)
        if self.pad_rows:
            grid = torch.nn.functional.pad(grid, (0, 0, 0, self.pad_rows))
        return grid.contiguous()

    def apply_keff(self, x, stiffness_scale, mass_factor):
        from ..ops import structured as _ops

        return _ops.apply_keff_structured(self, x, stiffness_scale, mass_factor)

    def assemble_node_blocks(self, stiffness_scale, mass_factor):
        from ..ops import structured as _ops

        return _ops.assemble_node_blocks_structured(
            self, stiffness_scale, mass_factor
        )

    @property
    def multigrid(self) -> bool:
        """Whether the V-cycle preconditions this model."""
        return self.preconditioner == "multigrid" and bool(self.mg_levels)

    def build_preconditioner(self, stiffness_scale, mass_factor):
        """The V-cycle's per-level inverses on a multigrid model, the
        class-table block-Jacobi on a homogeneous grid, else the per-node
        packed inverse (6, X, Y, Z): the class table's 27 blocks assume one
        material."""
        from ..ops import structured as _ops

        if self.multigrid:
            from ..ops import multigrid as _mg

            return _mg.build_mg_preconditioner(
                self, stiffness_scale, mass_factor
            )
        if self.homogeneous:
            return _ops.build_compact_block_jacobi(
                self, stiffness_scale, mass_factor
            )
        return _ops.build_block_jacobi_inverse_structured(
            self, stiffness_scale, mass_factor
        )

    def prefers_fused_pcg(self, block_inverse, vector_dtype) -> bool:
        """'auto' variant probe: Chronopoulos-Gear on a shard (one
        all-reduce per iteration) and where K2 runs on CUDA, classic
        elsewhere."""
        from ..ops import structured as _ops

        return self.shard_group is not None or (
            self.device.type == "cuda"
            and _ops.pc_keff_kernel_eligible(self, block_inverse, vector_dtype)
        )

    def build_fused_pcg_iteration(self, block_inverse, stiffness_scale,
                                  mass_factor, reduction_dtype,
                                  vector_dtype):
        """Whole-iteration PCG bundle (one K6 launch per iteration on
        CUDA), or None when ineligible — see ops.structured."""
        from ..ops import structured as _ops

        return _ops.build_fused_pcg_iteration(
            self, block_inverse, stiffness_scale, mass_factor,
            reduction_dtype, vector_dtype,
        )

    def apply_pc_keff(self, block_inverse, residual, stiffness_scale,
                      mass_factor):
        """(u, w) = (M^-1 r, K_eff u) — one kernel launch on CUDA where K2
        runs, else the preconditioner then the operator."""
        from ..ops import structured as _ops

        return _ops.apply_pc_keff_structured(
            self, block_inverse, residual, stiffness_scale, mass_factor
        )

    def apply_pc_keff_dots(self, block_inverse, residual, stiffness_scale,
                           mass_factor, reduction_dtype):
        """(u, w, (gamma, delta, rr)) with the three iteration dots
        reduced in the same kernel pass, or None where K2 does not run
        (the PCG loop composes)."""
        from ..ops import structured as _ops

        return _ops.apply_pc_keff_dots_structured(
            self, block_inverse, residual, stiffness_scale, mass_factor,
            reduction_dtype,
        )

    def apply_preconditioner(self, block_inverse, residual):
        """z = M^-1 r: the V-cycle on a multigrid model, K3 from a class
        table, else the per-node inverse (torch ops)."""
        from ..ops import structured as _ops

        if self.multigrid:
            from ..ops import multigrid as _mg

            return _mg.apply_mg_preconditioner(self, block_inverse, residual)
        if isinstance(block_inverse, _ops.CompactBlockJacobi):
            return _ops.apply_compact_preconditioner_structured(
                self, block_inverse, residual
            )
        return _ops.apply_preconditioner_structured(
            self, block_inverse, residual
        )

    def absorbing_force(self, v: torch.Tensor) -> torch.Tensor:
        """C v from the absorbing-face dashpots, bc-masked (zeros without
        absorbing faces): the Newmark right-hand side's damping force."""
        from ..ops import structured as _ops

        return _ops.absorbing_force_structured(self, v)


def interior_mass(mass_grid, nx: int, ny: int, nz: int) -> float:
    """The interior lumped-mass scalar ``m8 = rho * V_cell`` recovered from
    a stored mass grid: node (1, 1, 1) always exists (extents are n+1 >= 2)
    and carries ``m8 * 2^-d`` where d counts axes with n == 1.  Power-of-2
    scaling is exact in f32, so ``m8 * wx * wy * wz`` reproduces every
    stored value bitwise (pallas structured_stencil._interior_mass)."""
    corr = (
        (2.0 if nx == 1 else 1.0)
        * (2.0 if ny == 1 else 1.0)
        * (2.0 if nz == 1 else 1.0)
    )
    return float(np.float32(mass_grid[1, 1, 1]) * np.float32(corr))


def _box_plane_slice(tag: str, xs: int, axis_extents: Tuple[int, int, int]):
    """Grid slice for an axis plane tag "x0"/"x1"/"y0"/...; the +X physical
    boundary is plane xs-1 (NOT the padded end)."""
    axis = {"x": 0, "y": 1, "z": 2}[tag[0]]
    if tag[1] == "0":
        index = 0
    else:
        index = (xs - 1) if axis == 0 else axis_extents[axis] - 1
    sl = [slice(None)] * 3
    sl[axis] = index
    return axis, tuple(sl)


def _face_share(
    plane_tag: str,
    cell_counts: Tuple[int, int, int],
    spacings: Tuple[float, float, float],
) -> Tuple[int, np.ndarray]:
    """Equal nodal shares of face area on an axis plane (each boundary quad
    contributes area/4 to its 4 corner nodes, loads.cpp:104-149)."""
    axis = {"x": 0, "y": 1, "z": 2}[plane_tag[0]]
    face_dims = [d for d in range(3) if d != axis]
    face_area = spacings[face_dims[0]] * spacings[face_dims[1]]
    share = np.zeros([cell_counts[d] + 1 for d in face_dims])
    quad = np.full([cell_counts[d] for d in face_dims], face_area / 4.0)
    for da in (0, 1):
        for db in (0, 1):
            share[
                da : da + cell_counts[face_dims[0]],
                db : db + cell_counts[face_dims[1]],
            ] += quad
    return axis, share


def traction_force_grid(
    model: StructuredModel, plane_tag: str, value: Tuple[float, float, float]
) -> np.ndarray:
    """One traction's nodal force contribution in CSG layout (3, X, Y, Z),
    as a host numpy f32 array.  The plane is indexed through the real
    x-extent view, so y/z planes of an X-padded grid work too (the
    reference's version raises there); dead pad planes and rows carry no
    force."""
    counts = (model.nx, model.ny, model.nz)
    _, share = _face_share(plane_tag, counts, model.spacing)
    grid = np.zeros(model.global_grid_shape + (3,))
    _, sl = _box_plane_slice(
        plane_tag, model.nx + 1,
        (model.nx + 1, model.ny + 1, model.nz + 1),
    )
    grid[: model.nx + 1, : model.ny + 1][sl] = (
        share[..., None] * np.asarray(value, np.float64)
    )
    return grid.transpose(3, 0, 1, 2).astype(np.float32)


def build_structured_model(
    nx: int,
    ny: int,
    nz: int,
    material: ElasticProperties,
    density: float,
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    fixed_axis_planes: Tuple[str, ...] = ("x0",),
    traction: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    traction_plane: str = "x1",
    gravity: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    pad_x_multiple: int = 1,
    fixes: Optional[Sequence] = None,
    absorb_planes: Tuple[str, ...] = (),
    pad_y_multiple: int = 1,
    *,
    device,
    lam_grid=None,
    mu_grid=None,
    rho_grid=None,
):
    """Build the structured cantilever-style model + initial force on
    ``device``.

    ``fixed_axis_planes``/``traction_plane``: "x0"/"x1"/"y0"/... meaning the
    min/max plane normal to that axis.  ``fixes`` generalizes
    ``fixed_axis_planes`` to the reference's Dirichlet contract
    (config.cpp:500-567): a sequence of ``(plane_tag, constrain_axis(3,),
    values(3,))`` with per-axis flags and optional targets (None => 0).
    ``pad_x_multiple`` appends dead (constrained, massless) node planes
    along +X until (nx+1+pad) is a multiple; ``pad_y_multiple`` appends dead
    node rows along +Y the same way (the 2-D shard decomposition), and then
    pads the material cell grids along Y to the padded node extent, as the
    reference does.  ``absorb_planes`` names the
    absorbing faces; their impedances rho*c_p = sqrt(rho (lam + 2 mu)) and
    rho*c_s = sqrt(rho mu) come from the one material.

    ``lam_grid``/``mu_grid`` (arrays or tensors of (nx, ny, nz) cells,
    stored as f32; a missing one is filled with ``material``'s) give
    per-cell materials, as in the reference: a grid whose cells are all
    equal is homogeneous (lam0/mu0 taken from it), any other is
    heterogeneous, with lam0 = mu0 = 0.0, and refuses absorbing faces with
    the reference's ValueError.  The cell grids are padded with zero cells
    along +X to the padded node extent and, under ``pad_y_multiple`` > 1,
    along +Y too.  ``rho_grid`` ((nx, ny, nz) cells, f64; beyond the
    reference) gives per-cell densities: a node's mass is the sum over its
    cells of rho_c hx hy hz / 8 in f64, cast to f32 once, and gravity
    rides it.  A grid whose densities differ is heterogeneous whatever its
    lam and mu, and its ``m8`` is NaN: the kernels that synthesize the
    mass from ``m8`` decline it, and every reader of its mass reads
    ``mass_grid``.  An all-equal ``rho_grid`` is ``density``.

    Every other node-grid array is an analytic per-axis cell-adjacency
    count product (values in {0,1,2}) scaled by one f64 scalar, built in
    f64 on the device and cast to the storage dtype at the end — the same
    arithmetic as the reference's numpy and on-device builders, so the
    fields agree with both bit for bit.

    Returns (model, external_force (3, X, Y, Z) f32 tensor).
    """
    device = torch.device(device)
    xs, ys, zs = nx + 1, ny + 1, nz + 1
    pad_planes = (-xs) % max(pad_x_multiple, 1)
    xs_pad = xs + pad_planes
    pad_rows = (-ys) % max(pad_y_multiple, 1)
    ys_pad = ys + pad_rows
    cell_ys = ys_pad if pad_y_multiple > 1 else ny
    hx, hy, hz = (float(s) for s in spacing)
    lam0 = float(np.float32(material.lame.lam))
    mu0 = float(np.float32(material.lame.mu))
    f64, f32 = torch.float64, torch.float32

    def cell_grid(grid, dtype):
        grid = torch.as_tensor(
            np.asarray(grid) if not torch.is_tensor(grid) else grid
        ).to(device, dtype)
        if tuple(grid.shape) != (nx, ny, nz):
            raise ValueError(
                f"material grid of shape {tuple(grid.shape)}, expected "
                f"{(nx, ny, nz)} cells"
            )
        return grid

    def uniform(grid) -> bool:
        return bool(torch.all(grid == grid.reshape(-1)[0]))

    rho = None
    if rho_grid is not None:
        rho = cell_grid(rho_grid, f64)
        if uniform(rho):
            density, rho = float(rho.reshape(-1)[0]), None
    homogeneous = lam_grid is None and mu_grid is None and rho is None
    if not homogeneous:
        cells = [
            torch.full((nx, ny, nz), value, dtype=f32, device=device)
            if grid is None else cell_grid(grid, f32)
            for grid, value in ((lam_grid, lam0), (mu_grid, mu0))
        ]
        if rho is None and all(uniform(g) for g in cells):
            homogeneous = True
            lam0, mu0 = (float(g.reshape(-1)[0]) for g in cells)
        else:
            lam0 = mu0 = 0.0
    if absorb_planes and not homogeneous:
        raise ValueError(
            "absorbing faces on the structured path require a homogeneous "
            "material grid; use the general (Gmsh/packed) path for "
            "multi-material absorbing boundaries"
        )
    if fixes is None:
        fixes = [(tag, (True, True, True), (None, None, None))
                 for tag in fixed_axis_planes]

    ix = torch.arange(xs_pad, device=device)[:, None, None]
    iy = torch.arange(ys_pad, device=device)[None, :, None]
    iz = torch.arange(zs, device=device)[None, None, :]

    def adj(i, ncells):  # cells adjacent to node plane i along an axis
        return ((i >= 1) & (i <= ncells)).to(f64) + (i <= ncells - 1).to(f64)

    ax_, ay_, az_ = adj(ix, nx), adj(iy, ny), adj(iz, nz)
    counts = ax_ * ay_ * az_  # cells per node: 0 on pads and dead rows
    cm = density * (hx * hy * hz) / 8.0
    if rho is None:
        node_mass = counts * cm
    else:  # each node's cells, the 8 shifts of the zero-bordered cell grid
        share = F.pad(rho * ((hx * hy * hz) / 8.0), (1, 1, 1, 1, 1, 1))
        node_mass = torch.zeros((xs_pad, ys_pad, zs), dtype=f64, device=device)
        for a, b, c in CORNERS:
            node_mass[:xs, :ys] += share[a : a + xs, b : b + ys, c : c + zs]
    mass = node_mass.to(f32)

    # material grids: the cell values on real cells, 0 on the x/y pad tails
    if homogeneous:
        cell_real = (
            (torch.arange(xs_pad, device=device) < nx)[:, None, None]
            & (torch.arange(cell_ys, device=device) < ny)[None, :, None]
        ).expand(xs_pad, cell_ys, nz)
        lam = torch.where(cell_real, lam0, 0.0).to(f32)
        mu = torch.where(cell_real, mu0, 0.0).to(f32)
    else:
        lam, mu = (F.pad(g, (0, 0, 0, cell_ys - ny, 0, xs_pad - nx))
                   for g in cells)

    # Dirichlet planes, then the dead-pad override (the reference's order)
    bc = torch.zeros((3, xs_pad, ys_pad, zs), dtype=torch.bool, device=device)
    vals = torch.zeros((3, xs_pad, ys_pad, zs), dtype=f32, device=device)
    for tag, constrain, values in fixes:
        _, sl = _box_plane_slice(tag, xs, (xs, ys, zs))
        for a in range(3):
            if constrain[a]:
                bc[(a,) + sl] = True
                target = 0.0 if values[a] is None else float(values[a])
                vals[(a,) + sl] = float(np.float32(target))
    bc[:, xs:] = True
    vals[:, xs:] = 0.0
    bc[:, :, ys:] = True
    vals[:, :, ys:] = 0.0

    # nodal positions continue the lattice across the x pads (the
    # host-facing flat order has no dead Y rows)
    pos = torch.stack(
        [
            (ix.to(f64) * hx).expand(xs_pad, ys, zs),
            (iy[:, :ys].to(f64) * hy).expand(xs_pad, ys, zs),
            (iz.to(f64) * hz).expand(xs_pad, ys, zs),
        ],
        dim=-1,
    ).to(f32).reshape(xs_pad * ys * zs, 3)

    # external force: gravity rides the mass counts; the traction plane adds
    # face-area shares (the face-dim adjacency product)
    t_axis, _ = _box_plane_slice(traction_plane, xs, (xs, ys, zs))
    t_index = 0 if traction_plane[1] == "0" else (
        xs - 1 if t_axis == 0 else (ys, zs)[t_axis - 1] - 1
    )
    face_adj = [ax_, ay_, az_]
    face_adj[t_axis] = ((ix, iy, iz)[t_axis] == t_index).to(f64)
    face = face_adj[0] * face_adj[1] * face_adj[2]
    fd = [d for d in range(3) if d != t_axis]
    face_area = (hx, hy, hz)[fd[0]] * (hx, hy, hz)[fd[1]]
    a4t = (face_area / 4.0) * np.asarray(traction, np.float64)
    if rho is None:
        cmg = cm * np.asarray(gravity, np.float64)
        weight = [counts * float(cmg[c]) for c in range(3)]
    else:
        weight = [node_mass * float(gravity[c]) for c in range(3)]
    force = torch.stack(
        [weight[c] + face * float(a4t[c]) for c in range(3)]
    ).to(f32)

    from ..ops.structured import class_stencil_table, sweep_taps

    table = class_stencil_table((hx, hy, hz), lam0, mu0)
    model = StructuredModel(
        lam_grid=lam,
        mu_grid=mu,
        mass_grid=mass,
        bc_mask=bc,
        bc_value=vals,
        position0=pos,
        stencil_table=torch.as_tensor(table, device=device),
        sweep_taps=sweep_taps((hx, hy, hz), lam0, mu0),
        nx=nx,
        ny=ny,
        nz=nz,
        # pad planes sit at the end of the x-major flat order, so the real
        # nodes stay a contiguous prefix
        node_count=xs * ys * zs,
        padded_node_count=xs_pad * ys * zs,
        pad_planes=pad_planes,
        pad_rows=pad_rows,
        spacing=(hx, hy, hz),
        homogeneous=homogeneous,
        lam0=lam0,
        mu0=mu0,
        m8=float(np.float32(cm * 8.0)) if rho is None else float("nan"),
        absorb_faces=tuple(absorb_planes),
        rho_cp=float(np.sqrt(density * (lam0 + 2.0 * mu0)))
        if absorb_planes else 0.0,
        rho_cs=float(np.sqrt(density * mu0)) if absorb_planes else 0.0,
    )
    return model, force
