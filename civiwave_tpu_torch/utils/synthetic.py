"""Synthetic scenarios and meshes for benchmarks, smoke runs and tests.

Port of :mod:`civiwave_tpu.utils.synthetic` (numpy host code, copied):
``box_mesh`` builds an axis-aligned box of nx*ny*nz cells on
[0,nx]x[0,ny]x[0,nz] with FIXED (x=0 quads), LOAD_FACE (x=nx quads) and
SOLID groups — hex8 cells or their 6-tet split — and ``shuffle_mesh_nodes``
scrambles its node numbering.  Both give the same arrays as the JAX
package's from the same arguments and seed.  A scenario's ``box_regions``
(:func:`box_cell_groups`, which the JAX package lacks) add volume groups
that take the cells of their boxes from ``SOLID``.  The structured route
builds its grid from the ``synthetic://box/nx,ny,nz`` mesh path directly;
the general gather path meshes the box with ``box_mesh``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..config.loader import parse_config_node
from ..config.schema import BoxRegion, Config
from ..mesh.model import Mesh, PhysicalGroup, SENTINEL
from .errors import ConfigError

# physical-group id of box region r: after FIXED, LOAD_FACE, SOLID (1-3)
# and the six SIDE_* face groups (4-9)
REGION_GROUP_ID0 = 10

# consistent 6-tet decomposition of a hex (shared main diagonal 0-6)
_TET_CORNERS = np.array(
    [
        (0, 1, 2, 6),
        (0, 2, 3, 6),
        (0, 3, 7, 6),
        (0, 7, 4, 6),
        (0, 4, 5, 6),
        (0, 5, 1, 6),
    ],
    dtype=np.int64,
)


def _region_range(lo: float, hi: float, n: int):
    """The cells [i0, i1) of an axis of n cells whose centre fraction
    (i + 0.5) / n, in float64, lies in [lo, hi); None where there is none."""
    inside = np.nonzero((np.arange(n) + 0.5) / n >= lo)[0]
    inside = inside[(inside + 0.5) / n < hi]
    return None if inside.size == 0 else (int(inside[0]), int(inside[-1]) + 1)


def box_cell_groups(
    regions: Sequence[BoxRegion], nx: int, ny: int, nz: int, device="cpu",
) -> torch.Tensor:
    """(nx, ny, nz) int64 on ``device``: per cell, 0 for ``SOLID`` or
    r + 1 for the first of ``regions`` that holds the cell's centre.  A
    region that holds no cell at this size (too small, or shadowed by the
    regions before it) raises ConfigError naming it."""
    groups = torch.zeros((nx, ny, nz), dtype=torch.int64, device=device)
    for r in reversed(range(len(regions))):  # earlier regions paint last
        spans = [_region_range(regions[r].lo[a], regions[r].hi[a], n)
                 for a, n in enumerate((nx, ny, nz))]
        if None not in spans:
            (i0, i1), (j0, j1), (k0, k1) = spans
            groups[i0:i1, j0:j1, k0:k1] = r + 1
    if regions:
        counts = torch.bincount(groups.reshape(-1),
                                minlength=len(regions) + 1).tolist()
        for r, region in enumerate(regions):
            if counts[r + 1] == 0:
                raise ConfigError(
                    f"box region '{region.group}' holds no cell of the "
                    f"{nx}x{ny}x{nz} box", ["box_regions", f"[{r}]"])
    return groups


def box_mesh(
    nx: int, ny: int, nz: int, hex_elements: bool = False,
    spacing: float = 1.0, side_groups: bool = False,
    regions: Sequence[BoxRegion] = (),
) -> Mesh:
    """Structured box mesh; hex8 cells or their 6-tet decomposition.

    ``side_groups``: also emit the six face quad groups SIDE_X0..SIDE_Z1
    (ids 4-9) so scenarios can reference any box face — absorbing
    boundaries in particular (physics/absorbing.py).  Off by default to
    keep the canonical FIXED/LOAD_FACE-only surface table.  ``regions``
    (a scenario's ``box_regions``): region r is the volume group of id
    ``REGION_GROUP_ID0 + r`` and takes its cells (a hex, or its six tets)
    from SOLID, as :func:`box_cell_groups` places them."""
    xs, ys, zs = nx + 1, ny + 1, nz + 1
    grid = np.stack(
        np.meshgrid(
            np.arange(xs), np.arange(ys), np.arange(zs), indexing="ij"
        ),
        axis=-1,
    ).reshape(-1, 3)

    def nid(i, j, k):
        return (i * ys + j) * zs + k

    mesh = Mesh()
    mesh.node_positions = grid.astype(np.float64) * spacing
    mesh.node_original_ids = np.arange(1, len(grid) + 1, dtype=np.int64)

    # vectorized cell corner table (C, 8) in Gmsh hex ordering
    ii, jj, kk = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    ii, jj, kk = ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)
    cells = np.stack(
        [
            nid(ii, jj, kk),
            nid(ii + 1, jj, kk),
            nid(ii + 1, jj + 1, kk),
            nid(ii, jj + 1, kk),
            nid(ii, jj, kk + 1),
            nid(ii + 1, jj, kk + 1),
            nid(ii + 1, jj + 1, kk + 1),
            nid(ii, jj + 1, kk + 1),
        ],
        axis=1,
    ).astype(np.int64)

    if hex_elements:
        conn = cells.astype(np.int32)
        counts = np.full(len(cells), 8, dtype=np.int32)
        mesh.elements = conn
    else:
        tets = cells[:, _TET_CORNERS]  # (C, 6, 4)
        tets = tets.reshape(-1, 4)
        conn = np.full((len(tets), 8), SENTINEL, dtype=np.int32)
        conn[:, :4] = tets.astype(np.int32)
        counts = np.full(len(tets), 4, dtype=np.int32)
        mesh.elements = conn

    mesh.element_node_counts = counts
    mesh.element_physical_group = np.full(len(mesh.elements), 3, dtype=np.int64)
    if regions:
        cell_group = box_cell_groups(regions, nx, ny, nz).reshape(-1).numpy()
        ids = np.where(cell_group == 0, 3, REGION_GROUP_ID0 - 1 + cell_group)
        mesh.element_physical_group = (
            ids if hex_elements else np.repeat(ids, len(_TET_CORNERS)))
    mesh.element_original_ids = np.arange(1, len(mesh.elements) + 1, dtype=np.int64)

    # boundary quads at x=0 (FIXED, id 1) and x=nx (LOAD_FACE, id 2)
    jj2, kk2 = np.meshgrid(np.arange(ny), np.arange(nz), indexing="ij")
    jj2, kk2 = jj2.reshape(-1), kk2.reshape(-1)
    quads0 = np.stack(
        [
            nid(0, jj2, kk2),
            nid(0, jj2 + 1, kk2),
            nid(0, jj2 + 1, kk2 + 1),
            nid(0, jj2, kk2 + 1),
        ],
        axis=1,
    )
    quadsn = np.stack(
        [
            nid(nx, jj2, kk2),
            nid(nx, jj2 + 1, kk2),
            nid(nx, jj2 + 1, kk2 + 1),
            nid(nx, jj2, kk2 + 1),
        ],
        axis=1,
    )
    face_lists = [quads0, quadsn]
    face_group_ids = [1, 2]
    groups = [
        PhysicalGroup(2, 1, "FIXED"),
        PhysicalGroup(2, 2, "LOAD_FACE"),
        PhysicalGroup(3, 3, "SOLID"),
    ]
    if side_groups:
        def face_quads(axis: int, pos: int):
            """Quads tiling one axis plane of the box."""
            dims = [nx, ny, nz]
            a1, a2 = [a for a in range(3) if a != axis]
            u1, u2 = np.meshgrid(
                np.arange(dims[a1]), np.arange(dims[a2]), indexing="ij"
            )
            u1, u2 = u1.reshape(-1), u2.reshape(-1)

            def at(d1, d2):
                ijk = [None, None, None]
                ijk[axis] = np.full_like(u1, pos)
                ijk[a1] = u1 + d1
                ijk[a2] = u2 + d2
                return nid(*ijk)

            return np.stack(
                [at(0, 0), at(1, 0), at(1, 1), at(0, 1)], axis=1
            )

        tags = [
            ("SIDE_X0", 0, 0), ("SIDE_X1", 0, nx),
            ("SIDE_Y0", 1, 0), ("SIDE_Y1", 1, ny),
            ("SIDE_Z0", 2, 0), ("SIDE_Z1", 2, nz),
        ]
        for gid, (name, axis, pos) in enumerate(tags, start=4):
            face_lists.append(face_quads(axis, pos))
            face_group_ids.append(gid)
            groups.append(PhysicalGroup(2, gid, name))

    surfaces = np.concatenate(face_lists).astype(np.int32)
    mesh.surfaces = surfaces
    mesh.surface_node_counts = np.full(len(surfaces), 4, dtype=np.int32)
    mesh.surface_physical_group = np.concatenate(
        [
            np.full(len(f), gid)
            for f, gid in zip(face_lists, face_group_ids)
        ]
    ).astype(np.int64)
    mesh.surface_original_ids = np.arange(1, len(surfaces) + 1, dtype=np.int64)

    groups += [PhysicalGroup(3, REGION_GROUP_ID0 + r, region.group)
               for r, region in enumerate(regions)]
    mesh.physical_groups = groups
    mesh.group_lookup = {g.id: i for i, g in enumerate(groups)}
    mesh.surface_groups = {}
    start = 0
    for f, gid in zip(face_lists, face_group_ids):
        idx = np.arange(start, start + len(f), dtype=np.int64)
        mesh.surface_groups.setdefault(gid, []).append(idx)
        start += len(f)
    mesh.surface_groups = {
        gid: np.concatenate(parts)
        for gid, parts in mesh.surface_groups.items()
    }
    mesh.node_groups = {}
    return mesh


def split_last_hex(mesh: Mesh) -> Mesh:
    """A mixed tet4 + hex8 mesh: ``mesh`` (a hex box, modified in place and
    returned) with its last hex cell replaced by that cell's 6-tet split —
    the mixed case the JAX package's tests build
    (tests/test_windowed_gather.py:78-104)."""
    tets = mesh.elements[-1][_TET_CORNERS]  # (6, 4)
    tet_rows = np.full((6, 8), SENTINEL, dtype=np.int32)
    tet_rows[:, :4] = tets
    group = mesh.element_physical_group[-1]
    mesh.elements = np.concatenate([mesh.elements[:-1], tet_rows])
    mesh.element_node_counts = np.concatenate(
        [mesh.element_node_counts[:-1], np.full(6, 4, dtype=np.int32)]
    )
    mesh.element_physical_group = np.concatenate(
        [mesh.element_physical_group[:-1], np.full(6, group, dtype=np.int64)]
    )
    mesh.element_original_ids = np.arange(
        1, len(mesh.elements) + 1, dtype=np.int64
    )
    return mesh


def shuffle_mesh_nodes(mesh: Mesh, seed: int = 0) -> Mesh:
    """Randomly permute a mesh's node numbering — same geometry and
    topology, scrambled ids.

    Real Gmsh output is often far from bandwidth-optimal; the solver must
    be numbering-indifferent like the reference engine's CSR gather
    (src/gpu/pcg.cpp:653-661).  This helper produces the worst case for
    the gathers' locality, which the pack-time RCM renumbering
    (mesh/renumber.py) restores.
    """
    rng = np.random.default_rng(seed)
    n = mesh.node_count
    perm = rng.permutation(n).astype(np.int64)  # perm[old_id] = new_id
    iperm = np.argsort(perm)

    def remap(conn: np.ndarray) -> np.ndarray:
        safe = np.where(conn == SENTINEL, 0, conn).astype(np.int64)
        return np.where(conn == SENTINEL, SENTINEL, perm[safe]).astype(
            conn.dtype
        )

    out = Mesh()
    out.node_positions = mesh.node_positions[iperm]
    out.node_original_ids = mesh.node_original_ids[iperm]
    out.elements = remap(mesh.elements)
    out.element_node_counts = mesh.element_node_counts.copy()
    out.element_physical_group = mesh.element_physical_group.copy()
    out.element_original_ids = mesh.element_original_ids.copy()
    out.surfaces = remap(mesh.surfaces)
    out.surface_node_counts = mesh.surface_node_counts.copy()
    out.surface_physical_group = mesh.surface_physical_group.copy()
    out.surface_original_ids = mesh.surface_original_ids.copy()
    out.physical_groups = list(mesh.physical_groups)
    out.group_lookup = dict(mesh.group_lookup)
    out.node_groups = {
        gid: perm[np.asarray(idx, dtype=np.int64)]
        for gid, idx in mesh.node_groups.items()
    }
    # surface_groups hold SURFACE indices, not node ids — copy verbatim
    out.surface_groups = {
        gid: np.asarray(idx).copy()
        for gid, idx in mesh.surface_groups.items()
    }
    return out


def cantilever_config(
    tol_runtime: float = 1.0e-6,
    tol_pause: float = 1.0e-8,
    max_iters: int = 400,
    dt: float = 1.0e-3,
    adaptive: bool = False,
    traction: float = -1.0e6,
    **extra: Dict,
) -> Config:
    """Steel cantilever scenario matching the synthetic box's group names
    (FIXED = x0 plane, LOAD_FACE = x1 plane, SOLID = every cell).  Pass
    e.g. ``mesh={"path": "synthetic://box/255,255,255"}`` to size it."""
    node = {
        "mesh": {"path": "synthetic://box"},
        "materials": [
            {"name": "steel", "E": 2.0e11, "nu": 0.3, "rho": 7800.0}
        ],
        "assignments": [{"group": "SOLID", "material": "steel"}],
        "damping": {"xi": 0.02, "w1": 10.0, "w2": 100.0},
        "time": {
            "dt": dt,
            "adaptive": adaptive,
            "min_dt": dt * 0.5,
            "max_dt": dt * 2.0,
        },
        "solver": {
            "type": "pcg",
            "preconditioner": "block_jacobi",
            "tol_runtime": tol_runtime,
            "tol_pause": tol_pause,
            "max_iters": max_iters,
        },
        "precision": {"vectors": "fp32", "reductions": "fp64"},
        "loads": {
            "gravity": [0.0, 0.0, 0.0],
            "tractions": [{"group": "LOAD_FACE", "value": [0.0, 0.0, traction]}],
        },
        "dirichlet": {"fixes": [{"group": "FIXED", "dof": ["x", "y", "z"]}]},
        "output": {"vtu_stride": 1, "probes": []},
    }
    node.update(extra)
    return parse_config_node(node)


def soil_column_config(
    cells=(1023, 47, 47), spacing: float = 0.25, **extra: Dict
) -> Config:
    """Site-response soil column on a compliant base: a deep, narrow box of
    hex cells with X the depth (the default is 255.75 m deep and 11.75 m x
    11.75 m: 1024 x 48 x 48 nodes, 7,077,888 DOF).  The material, damping,
    time step, solver and pulse are ``examples/seismic_basin.yaml``'s; the
    base (SIDE_X0) is a Lysmer-Kuhlemeyer absorbing face that feeds the
    input wave as a horizontal shear traction under the pulse; the sides
    and the top are free.  ``extra`` replaces top-level keys."""
    nx, ny, nz = cells
    node = {
        "mesh": {"path": f"synthetic://box/{nx},{ny},{nz},hex,{spacing}"},
        "materials": [{"name": "soil", "E": 2.0e8, "nu": 0.3, "rho": 1800.0}],
        "assignments": [{"group": "SOLID", "material": "soil"}],
        "damping": {"xi": 0.01, "w1": 5.0, "w2": 50.0},
        "time": {"dt": 0.002, "adaptive": False},
        "solver": {
            "type": "pcg",
            "preconditioner": "block_jacobi",
            "tol_runtime": 2.0e-4,
            "tol_pause": 1.0e-5,
            "max_iters": 120,
        },
        "precision": {"vectors": "fp32", "reductions": "fp64"},
        "curves": {"pulse": [[0.0, 0.0], [0.02, 1.0], [0.04, -0.6],
                             [0.06, 0.15], [0.08, 0.0]]},
        "loads": {
            "gravity": [0.0, 0.0, 0.0],
            "tractions": [{"group": "SIDE_X0", "value": [0.0, 5.0e4, 0.0],
                           "scale_curve": "pulse"}],
        },
        "dirichlet": {"fixes": []},
        "boundaries": {"absorbing": ["SIDE_X0"]},
        "output": {"vtu_stride": 10, "probes": [0]},
    }
    node.update(extra)
    return parse_config_node(node)
