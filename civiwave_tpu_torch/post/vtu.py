"""Binary VTU (UnstructuredGrid) writer.

Copy of :mod:`civiwave_tpu.post.vtu` (host numpy, byte for byte the same
files), a byte-format rebuild of src/post/vtu_writer.cpp:171-297:
appended raw encoding with UInt32 block headers, little-endian, PointData
(displacement/velocity/acceleration 3-comp, nodal strain/stress 6-comp
Voigt, von Mises scalar), CellData (element strain/stress/von Mises),
deformed points = x0 + u, VTK cell types 10 (tet4) / 12 (hex8), FieldData
time + frame.  Output opens in ParaView interchangeably with reference
output.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..mesh.model import Mesh, SENTINEL
from ..utils.errors import VtuError
from .derived import DerivedFieldSet

_VTK_TETRA = 10
_VTK_HEX = 12


def _blocks_and_offsets(arrays: List[np.ndarray]) -> tuple:
    """Appended-data blob: each block is u32 byte-count + raw bytes
    (vtu_writer.cpp:138-152)."""
    blob = bytearray()
    offsets = []
    for arr in arrays:
        raw = np.ascontiguousarray(arr).tobytes()
        offsets.append(len(blob))
        blob += np.uint32(len(raw)).tobytes()
        blob += raw
    return bytes(blob), offsets


def _cells_arrays(mesh: Mesh):
    """Vectorized connectivity/offsets/types (the per-element Python loop
    took seconds per frame at 300k+ elements)."""
    counts = mesh.element_node_counts.astype(np.int32)
    if counts.size == 0:
        return (
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
            np.zeros(0, np.uint8),
        )
    valid = np.arange(mesh.elements.shape[1])[None, :] < counts[:, None]
    connectivity = mesh.elements[valid].astype(np.int32)  # row-major ragged
    cell_offsets = np.cumsum(counts, dtype=np.int32)
    cell_types = np.where(counts == 4, _VTK_TETRA, _VTK_HEX).astype(np.uint8)
    return connectivity, cell_offsets, cell_types


def _write_header(
    f,
    n_points: int,
    n_cells: int,
    point_meta,  # [(name, comps), ...]
    cell_meta,
    point_offs,
    cell_offs,
    points_off: int,
    conn_off: int,
    offsets_off: int,
    types_off: int,
    simulation_time: float,
    frame_index: int,
) -> None:
    """XML header + appended-data prefix (shared by both writers; byte
    format of vtu_writer.cpp:171-291)."""

    def w(text: str) -> None:
        f.write(text.encode("ascii"))

    w('<?xml version="1.0"?>\n')
    w(
        '<VTKFile type="UnstructuredGrid" version="1.0" '
        'byte_order="LittleEndian" header_type="UInt32">\n'
    )
    w("  <UnstructuredGrid>\n")
    w("    <FieldData>\n")
    w(
        f'      <DataArray type="Float64" Name="time" NumberOfTuples="1">'
        f"{simulation_time:.17g}</DataArray>\n"
    )
    w(
        f'      <DataArray type="UInt32" Name="frame" NumberOfTuples="1">'
        f"{frame_index}</DataArray>\n"
    )
    w("    </FieldData>\n")
    w(
        f'    <Piece NumberOfPoints="{n_points}" '
        f'NumberOfCells="{n_cells}">\n'
    )

    w('      <PointData Scalars="von_mises_node">\n')
    for (name, comps), off in zip(point_meta, point_offs):
        w(
            f'        <DataArray type="Float32" Name="{name}" '
            f'NumberOfComponents="{comps}" format="appended" '
            f'offset="{off}"/>\n'
        )
    w("      </PointData>\n")

    w('      <CellData Scalars="von_mises_elem">\n')
    for (name, comps), off in zip(cell_meta, cell_offs):
        w(
            f'        <DataArray type="Float32" Name="{name}" '
            f'NumberOfComponents="{comps}" format="appended" '
            f'offset="{off}"/>\n'
        )
    w("      </CellData>\n")

    w("      <Points>\n")
    w(
        f'        <DataArray type="Float32" NumberOfComponents="3" '
        f'format="appended" offset="{points_off}"/>\n'
    )
    w("      </Points>\n")

    w("      <Cells>\n")
    w(
        f'        <DataArray type="Int32" Name="connectivity" '
        f'format="appended" offset="{conn_off}"/>\n'
    )
    w(
        f'        <DataArray type="Int32" Name="offsets" '
        f'format="appended" offset="{offsets_off}"/>\n'
    )
    w(
        f'        <DataArray type="UInt8" Name="types" '
        f'format="appended" offset="{types_off}"/>\n'
    )
    w("      </Cells>\n")

    w("    </Piece>\n")
    w("  </UnstructuredGrid>\n")
    w('  <AppendedData encoding="raw">\n')
    w("_")


def _field_arrays(displacement, velocity, acceleration, derived, n: int):
    # copy=False: already-f32 fields pass through untouched — gratuitous
    # .astype copies cost ~90 s / 2.5 GB at 50M DOF on slow-fault hosts
    def f32(a):
        return np.asarray(a, dtype=np.float32)

    point_arrays = [
        ("displacement", 3, f32(displacement[:n])),
        ("velocity", 3, f32(velocity[:n])),
        ("acceleration", 3, f32(acceleration[:n])),
        ("strain_node", 6, f32(derived.node_strain)),
        ("stress_node", 6, f32(derived.node_stress)),
        ("von_mises_node", 1, f32(derived.node_von_mises)),
    ]
    cell_arrays = [
        ("strain_elem", 6, f32(derived.element_strain)),
        ("stress_elem", 6, f32(derived.element_stress)),
        ("von_mises_elem", 1, f32(derived.element_von_mises)),
    ]
    return point_arrays, cell_arrays


def write_vtu_structured(
    path: str,
    nx: int,
    ny: int,
    nz: int,
    points: np.ndarray,  # (N, 3) f32 DEFORMED coordinates (x0 + u)
    displacement: np.ndarray,  # (N, 3) f32
    velocity: np.ndarray,
    acceleration: np.ndarray,
    derived: DerivedFieldSet,
    simulation_time: float,
    frame_index: int,
) -> None:
    """Write one structured-box frame with IMPLICIT connectivity.

    Byte-identical to ``write_vtu`` over ``box_mesh(nx, ny, nz,
    hex_elements=True)``, but the connectivity/offsets/types blocks are
    generated from (nx, ny, nz) in fixed-size chunks while streaming — at
    50M DOF the explicit path materializes ~1.6 GB of host connectivity
    (int64 box_mesh + int32 copy) per run; this path materializes ~32 MB.
    Node order x-major, cells i-major, Gmsh corner order
    (mesh/structured.py:40-60); the reference's writer
    (vtu_writer.cpp:171-291) only ever faced 150k DOF.
    """
    n = (nx + 1) * (ny + 1) * (nz + 1)
    n_cells = nx * ny * nz
    if 8 * n_cells > np.iinfo(np.int32).max or n > np.iinfo(np.int32).max:
        raise VtuError(
            "structured VTU exceeds Int32 offsets capacity "
            f"({n_cells} cells)",
            [str(path)],
        )
    try:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)

        points = np.ascontiguousarray(points[:n], dtype=np.float32)
        point_arrays, cell_arrays = _field_arrays(
            displacement, velocity, acceleration, derived, n
        )

        from . import native_vtu

        if native_vtu.available():
            status = native_vtu.write_vtu_structured_native(
                path, nx, ny, nz, points, point_arrays, cell_arrays,
                simulation_time, frame_index,
            )
            if status != 0:
                raise VtuError(
                    f"native VTU writer failed (status {status})", [str(path)]
                )
            return

        # pure-Python fallback: same streaming layout
        sizes = (
            [n * c * 4 for _, c, _ in point_arrays]
            + [n_cells * c * 4 for _, c, _ in cell_arrays]
            + [n * 12, n_cells * 32, n_cells * 4, n_cells]
        )
        offs = []
        running = 0
        for s in sizes:
            offs.append(running)
            running += 4 + s
        point_offs = offs[: len(point_arrays)]
        cell_offs = offs[len(point_arrays) : len(point_arrays) + len(cell_arrays)]
        points_off, conn_off, offsets_off, types_off = offs[-4:]

        with open(path, "wb") as f:
            _write_header(
                f, n, n_cells,
                [(nm, c) for nm, c, _ in point_arrays],
                [(nm, c) for nm, c, _ in cell_arrays],
                point_offs, cell_offs,
                points_off, conn_off, offsets_off, types_off,
                simulation_time, frame_index,
            )

            def block(arr: np.ndarray) -> None:
                raw = np.ascontiguousarray(arr)
                f.write(np.uint32(raw.nbytes).tobytes())
                f.write(raw.tobytes())

            for _, _, a in point_arrays:
                block(a)
            for _, _, a in cell_arrays:
                block(a)
            block(points)

            chunk = 1 << 20
            dz, dy, dx = 1, nz + 1, (ny + 1) * (nz + 1)
            delta = np.array(
                [0, dx, dx + dy, dy, dz, dx + dz, dx + dy + dz, dy + dz],
                np.int32,
            )
            f.write(np.uint32(n_cells * 32).tobytes())
            for start in range(0, n_cells, chunk):
                c = np.arange(
                    start, min(start + chunk, n_cells), dtype=np.int64
                )
                i, rem = np.divmod(c, ny * nz)
                j, k = np.divmod(rem, nz)
                nid = ((i * (ny + 1) + j) * (nz + 1) + k).astype(np.int32)
                f.write((nid[:, None] + delta).tobytes())
            f.write(np.uint32(n_cells * 4).tobytes())
            for start in range(0, n_cells, chunk):
                stop = min(start + chunk, n_cells)
                f.write(
                    ((np.arange(start, stop, dtype=np.int32) + 1) * 8).tobytes()
                )
            f.write(np.uint32(n_cells).tobytes())
            types_chunk = np.full(min(chunk, n_cells), _VTK_HEX, np.uint8)
            for start in range(0, n_cells, chunk):
                f.write(types_chunk[: min(chunk, n_cells - start)].tobytes())

            f.write(b"\n  </AppendedData>\n</VTKFile>\n")
    except OSError as exc:
        raise VtuError(str(exc), [str(path)]) from None


def write_vtu(
    path: str,
    mesh: Mesh,
    displacement: np.ndarray,  # (N, 3) f32
    velocity: np.ndarray,
    acceleration: np.ndarray,
    derived: DerivedFieldSet,
    simulation_time: float,
    frame_index: int,
) -> None:
    """Write one frame (vtu_writer.cpp:171-291).

    Dispatches to the native C++ writer (native/vtu_fast.cpp) when the
    toolchain is available; the pure-Python path below is byte-identical.
    """
    try:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)

        n = mesh.node_count
        points = (mesh.node_positions.astype(np.float32) + displacement[:n]).astype(
            np.float32
        )

        point_arrays, cell_arrays = _field_arrays(
            displacement, velocity, acceleration, derived, n
        )

        from . import native_vtu

        if native_vtu.available():
            # stream connectivity/offsets/types straight from the padded
            # element table — the ragged extraction + cumsum of
            # _cells_arrays materializes ~600 MB/frame at 10M-DOF tets
            status = native_vtu.write_vtu_padded_native(
                path,
                points,
                mesh.elements,
                mesh.element_node_counts,
                point_arrays,
                cell_arrays,
                simulation_time,
                frame_index,
            )
            if status != 0:
                raise VtuError(
                    f"native VTU writer failed (status {status})", [str(path)]
                )
            return

        connectivity, cell_offsets, cell_types = _cells_arrays(mesh)

        blob, offs = _blocks_and_offsets(
            [a for _, _, a in point_arrays]
            + [a for _, _, a in cell_arrays]
            + [points, connectivity, cell_offsets, cell_types]
        )
        point_offs = offs[: len(point_arrays)]
        cell_offs = offs[len(point_arrays) : len(point_arrays) + len(cell_arrays)]
        points_off, conn_off, offsets_off, types_off = offs[-4:]

        with open(path, "wb") as f:
            _write_header(
                f, n, mesh.element_count,
                [(nm, c) for nm, c, _ in point_arrays],
                [(nm, c) for nm, c, _ in cell_arrays],
                point_offs, cell_offs,
                points_off, conn_off, offsets_off, types_off,
                simulation_time, frame_index,
            )
            f.write(blob)
            f.write(b"\n  </AppendedData>\n</VTKFile>\n")
    except OSError as exc:
        raise VtuError(str(exc), [str(path)]) from None
