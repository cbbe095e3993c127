"""Mesh preprocessing: validation, shape gradients, masses, adjacency.

Copy of :mod:`civiwave_tpu.mesh.preprocess` (numpy only; the port keeps its
own copy so it never imports the JAX package).  The structured route reads
``hex_gradients`` for its constant element tables; the general gather path
runs the full :func:`run`.  It is a rebuild of the reference engine's
src/mesh/preprocess.cpp:284-404 with two deliberate upgrades:

1. **Vectorized numpy** throughout (the reference loops per element).
2. **Real hex8 support.** The reference rejects hexes ("only tetrahedron
   elements supported in Phase 3", preprocess.cpp:326-330) even though its
   data model carries 8-slot connectivity.  Here each hex8 expands into its
   8 Gauss-point rows (2x2x2 quadrature), each row carrying its own (8,3)
   gradient table and point volume ``w_g * detJ_g``.  A tet4 contributes one
   row with its exact constant gradients.  This keeps a *single* element
   kernel shape for the whole framework: every quadrature row is
   (connectivity[8], gradients[8,3], volume, material) — exactly the layout
   the reference's Slang kernel consumed (ke_apply_element.slang), now
   uniform across element types.

Per-row semantics preserved from the reference:
* tet gradients from cross products with signed 6V (preprocess.cpp:268-280),
  volume = |6V|/6 (preprocess.cpp:343-352);
* lumped mass = rho * V / n_nodes scattered to corners
  (preprocess.cpp:370-375);
* CSR node -> (row, local slot) adjacency (preprocess.cpp:378-401);
* duplicate node/element detection and config-group validation with the
  reference's error messages (preprocess.cpp:82-266).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from ..config.schema import Config
from ..utils.errors import PreprocessError
from .model import Mesh, SENTINEL

_DUPLICATE_EPS = 1.0e-12  # preprocess.cpp:84


@dataclass
class NodeAdjacency:
    """CSR node -> (quadrature row, local slot) map (preprocess.hpp:40-45)."""

    offsets: np.ndarray  # (N+1,) int64
    row_indices: np.ndarray  # (total,) int64 — quadrature row index
    local_indices: np.ndarray  # (total,) int8 — local slot within the row


@dataclass
class PreprocessOutputs:
    """Preprocessing products (preprocess.hpp:50-57 + quadrature expansion).

    Storage is ELEMENT-TYPE-BLOCKED (tet tables + hex tables) because that
    is what the packer consumes directly — the hex gradients in particular
    are produced straight in the gp-major ``(8gp, 8l, 3, H)`` layout the
    device tables use, so multi-million-hex grids never materialize the
    ~6.8 GB element-major form.  The reference-shaped flat quadrature-row
    views (``quad_*``, rows = tets then 8 rows per hex) and the CSR
    ``adjacency`` are built lazily on first access; they are only needed
    by the dense oracle, the host derived-field twin and tests — all
    small-mesh consumers.
    """

    # per input element
    element_volumes: np.ndarray  # (E,) float64 — total element volume
    element_material_index: np.ndarray  # (E,) int32
    # tet block (one quadrature row per tet, constant gradients)
    tet_connectivity: np.ndarray  # (T, 8) int32, SENTINEL-padded rows
    tet_gradients: np.ndarray  # (T, 4, 3) float64
    tet_volume: np.ndarray  # (T,) float64
    tet_material: np.ndarray  # (T,) int32
    tet_elements: np.ndarray  # (T,) int64 — owning element index
    # hex block (2x2x2 Gauss, gp-major-transposed tables)
    hex_connectivity: np.ndarray  # (H, 8) int32
    hex_gradients_gp: np.ndarray  # (8gp, 8l, 3, H) float32
    hex_detj: np.ndarray  # (8gp, H) float64 — w_g * detJ_g (unit weights)
    hex_material: np.ndarray  # (H,) int32
    hex_elements: np.ndarray  # (H,) int64
    # per node
    lumped_mass: np.ndarray  # (N,) float64
    node_count: int = 0
    # lazy caches (reference-shaped views)
    _quad_connectivity: np.ndarray = field(default=None, repr=False)  # type: ignore[assignment]
    _quad_gradients: np.ndarray = field(default=None, repr=False)  # type: ignore[assignment]
    _adjacency: NodeAdjacency = field(default=None, repr=False)  # type: ignore[assignment]

    @property
    def tet_count(self) -> int:
        return int(self.tet_volume.shape[0])

    @property
    def hex_count(self) -> int:
        return int(self.hex_detj.shape[1])

    @property
    def quad_count(self) -> int:
        return self.tet_count + 8 * self.hex_count

    # --- lazy reference-shaped quadrature-row views ----------------------
    @property
    def quad_connectivity(self) -> np.ndarray:
        """(Q, 8) int32, SENTINEL padded; rows = tets then 8 per hex."""
        if self._quad_connectivity is None:
            self._quad_connectivity = np.concatenate(
                [
                    self.tet_connectivity.reshape(-1, 8),
                    np.repeat(self.hex_connectivity, 8, axis=0),
                ]
            ).astype(np.int32)
        return self._quad_connectivity

    @property
    def quad_gradients(self) -> np.ndarray:
        """(Q, 8, 3) float64, zero padded (tet rows use slots 0..3)."""
        if self._quad_gradients is None:
            t = self.tet_count
            grads8 = np.zeros((self.quad_count, 8, 3))
            grads8[:t, :4] = self.tet_gradients
            # (8gp, 8l, 3, H) -> (H, 8gp, 8l, 3) -> (8H, 8, 3)
            grads8[t:] = self.hex_gradients_gp.transpose(3, 0, 1, 2).reshape(
                -1, 8, 3
            )
            self._quad_gradients = grads8
        return self._quad_gradients

    @property
    def quad_volume(self) -> np.ndarray:
        return np.concatenate(
            [self.tet_volume, self.hex_detj.T.reshape(-1)]
        )

    @property
    def quad_material_index(self) -> np.ndarray:
        return np.concatenate(
            [self.tet_material, np.repeat(self.hex_material, 8)]
        ).astype(np.int32)

    @property
    def quad_element(self) -> np.ndarray:
        return np.concatenate(
            [self.tet_elements, np.repeat(self.hex_elements, 8)]
        ).astype(np.int64)

    @property
    def adjacency(self) -> NodeAdjacency:
        """CSR node -> (row, slot) map, built on first access."""
        if self._adjacency is None:
            self._adjacency = _build_adjacency(
                self.quad_connectivity, self.node_count
            )
        return self._adjacency


def _check_duplicate_nodes(mesh: Mesh) -> None:
    """Spatial-hash duplicate detection (preprocess.cpp:82-128)."""
    if mesh.node_count == 0:
        return
    quantized = np.floor_divide(mesh.node_positions, _DUPLICATE_EPS).astype(np.int64)
    _, inverse, counts = np.unique(
        quantized, axis=0, return_inverse=True, return_counts=True
    )
    dup_buckets = np.nonzero(counts > 1)[0]
    if dup_buckets.size == 0:
        return
    order = np.argsort(inverse, kind="stable")
    sorted_inverse = inverse[order]
    boundaries = np.searchsorted(sorted_inverse, dup_buckets)
    for bucket, start in zip(dup_buckets, boundaries):
        members = order[start : start + counts[bucket]]
        pos = mesh.node_positions[members]
        for i in range(len(members)):
            delta = pos[i + 1 :] - pos[i]
            dist_sq = np.einsum("ij,ij->i", delta, delta)
            hits = np.nonzero(dist_sq < _DUPLICATE_EPS * _DUPLICATE_EPS)[0]
            if hits.size:
                a, b = int(members[i]), int(members[i + 1 + hits[0]])
                raise PreprocessError(
                    f"duplicate nodes detected: node {min(a, b)} and node "
                    f"{max(a, b)} at same position",
                    ["mesh", "nodes"],
                )


def _check_duplicate_elements(mesh: Mesh) -> None:
    """Connectivity-hash duplicate detection (preprocess.cpp:130-192)."""
    if mesh.element_count == 0:
        return
    sorted_conn = np.sort(mesh.elements, axis=1)  # SENTINEL=-1 sorts first, harmless
    keyed = np.concatenate(
        [mesh.element_node_counts[:, None].astype(np.int32), sorted_conn], axis=1
    )
    _, inverse, counts = np.unique(keyed, axis=0, return_inverse=True, return_counts=True)
    dup = np.nonzero(counts > 1)[0]
    if dup.size:
        first_bucket = dup[0]
        members = np.nonzero(inverse == first_bucket)[0]
        raise PreprocessError(
            f"duplicate elements detected: element {int(members[0])} and element "
            f"{int(members[1])} have same connectivity",
            ["mesh", "elements"],
        )


def _validate_config_groups(mesh: Mesh, cfg: Config) -> None:
    """Group existence checks (preprocess.cpp:194-266)."""
    name_to_group = mesh.group_name_to_id()

    for i, fix in enumerate(cfg.dirichlet):
        if fix.group not in name_to_group:
            raise PreprocessError(
                f"dirichlet fix references missing physical group '{fix.group}'",
                ["dirichlet", "fixes", f"[{i}]"],
            )
        group_id = name_to_group[fix.group]
        has_surfaces = len(mesh.surface_groups.get(group_id, ())) > 0
        has_nodes = len(mesh.node_groups.get(group_id, ())) > 0
        if not has_surfaces and not has_nodes:
            raise PreprocessError(
                f"dirichlet group '{fix.group}' has no discretized faces or nodes",
                ["dirichlet", "fixes", f"[{i}]"],
            )

    for i, traction in enumerate(cfg.loads.tractions):
        if traction.group not in name_to_group:
            raise PreprocessError(
                f"traction load references missing physical group '{traction.group}'",
                ["loads", "tractions", f"[{i}]"],
            )
        group_id = name_to_group[traction.group]
        if len(mesh.surface_groups.get(group_id, ())) == 0:
            raise PreprocessError(
                f"traction group '{traction.group}' has no discretized faces",
                ["loads", "tractions", f"[{i}]"],
            )

    for i, load in enumerate(cfg.loads.points):
        if load.group not in name_to_group:
            raise PreprocessError(
                f"point load references missing physical group '{load.group}'",
                ["loads", "points", f"[{i}]"],
            )
        group_id = name_to_group[load.group]
        if len(mesh.node_groups.get(group_id, ())) == 0:
            raise PreprocessError(
                f"point load group '{load.group}' has no tagged nodes",
                ["loads", "points", f"[{i}]"],
            )


def bind_materials(mesh: Mesh, cfg: Config) -> Dict[int, int]:
    """Physical-group id -> material index (preprocess.cpp:36-75)."""
    name_to_group = mesh.group_name_to_id()
    material_names = [mat.name for mat in cfg.materials]
    binding: Dict[int, int] = {}
    for i, assignment in enumerate(cfg.assignments):
        if assignment.group not in name_to_group:
            raise PreprocessError(
                f"assignment references missing physical group '{assignment.group}'",
                ["assignments", f"[{i}]"],
            )
        if assignment.material not in material_names:
            raise PreprocessError(
                f"assignment references missing material '{assignment.material}'",
                ["assignments", f"[{i}]"],
            )
        binding[name_to_group[assignment.group]] = material_names.index(
            assignment.material
        )
    return binding


def tet_gradients(positions: np.ndarray) -> tuple:
    """Constant shape-function gradients + volume for tet4 batches.

    positions: (T, 4, 3) float64.  Returns (gradients (T,4,3), volume (T,)).
    Matches compute_tet_gradients (preprocess.cpp:268-280): signed 6V from the
    scalar triple product, gradients scaled by -1/6V.
    """
    p0, p1, p2, p3 = (positions[:, i, :] for i in range(4))
    e0, e1, e2 = p1 - p0, p2 - p0, p3 - p0
    volume6 = np.einsum("ij,ij->i", e0, np.cross(e1, e2))
    with np.errstate(divide="ignore", invalid="ignore"):
        inv6 = -1.0 / volume6
        inv6 = np.where(np.isfinite(inv6), inv6, 0.0)  # degenerate tets error later
    grads = np.stack(
        [
            np.cross(p2 - p1, p3 - p1),
            np.cross(p3 - p0, p2 - p0),
            np.cross(p1 - p0, p3 - p0),
            np.cross(p2 - p0, p1 - p0),
        ],
        axis=1,
    )
    grads = grads * inv6[:, None, None]
    volume = np.abs(volume6) / 6.0
    return grads, volume


# trilinear hex8 reference coordinates (Gmsh node ordering)
_HEX_XI = np.array(
    [
        [-1.0, -1.0, -1.0],
        [1.0, -1.0, -1.0],
        [1.0, 1.0, -1.0],
        [-1.0, 1.0, -1.0],
        [-1.0, -1.0, 1.0],
        [1.0, -1.0, 1.0],
        [1.0, 1.0, 1.0],
        [-1.0, 1.0, 1.0],
    ]
)
_GAUSS_1D = 1.0 / np.sqrt(3.0)


def _hex_gp_shape_gradients() -> np.ndarray:
    """dN/dxi at the 8 Gauss points: (8 gp, 8 node, 3) in reference coords."""
    gps = _HEX_XI * _GAUSS_1D  # 2x2x2 points share the corner pattern
    out = np.zeros((8, 8, 3))
    for g, (gx, gy, gz) in enumerate(gps):
        for l, (sx, sy, sz) in enumerate(_HEX_XI):
            out[g, l, 0] = 0.125 * sx * (1 + sy * gy) * (1 + sz * gz)
            out[g, l, 1] = 0.125 * sy * (1 + sx * gx) * (1 + sz * gz)
            out[g, l, 2] = 0.125 * sz * (1 + sx * gx) * (1 + sy * gy)
    return out


_HEX_DN = _hex_gp_shape_gradients()  # (8, 8, 3)


def hex_gradients_gp_major(positions: np.ndarray, dtype=np.float64) -> tuple:
    """Per-Gauss-point physical gradients + detJ in gp-major layout.

    positions: (H, 8, 3).  Returns (gradients (8gp, 8l, 3, H) ``dtype``,
    det (8gp, H) f64) — the exact layout the packed device tables use
    (mesh/pack.py grads_hex), so multi-million-hex preprocessing never
    materializes the element-major (H, 8, 8, 3) form.  The Jacobian and
    its inverse are always computed in f64; ``dtype=float32`` stores the
    final gradient table in the precision the device tables use anyway,
    halving the dominant memory stream (the f64->f32 rounding happens one
    GEMM earlier than the reference's pack-time cast, a ~1 ulp
    difference on a K=3 contraction).

    Throughput design (the 8-minute-pack fix, round-2 VERDICT item 3):
    the Jacobian is ONE (24, 8) x (8, 3H) BLAS GEMM; the 3x3 inverse is
    the closed-form adjugate on CONTIGUOUS (H,) component streams (the
    batched LAPACK ``np.linalg.inv`` spent 6.6 s on 524k hexes where this
    spends milliseconds, and strided (..., 3, 3) component slices made
    even closed-form arithmetic gather-bound); the physical gradients are
    8 per-gp (8, 3) x (3, 3H) GEMMs.  Same math as the reference-cited
    J = dN.x, grad = J^-1 dN (2x2x2 Gauss, unit weights).
    """
    h = positions.shape[0]
    # J[g, a, b] = sum_l dN[g, l, a] x[l, b] as one GEMM per gp:
    # (3a, 8l) @ (8l, 3b*H) -> jac[a, b, H] with contiguous (H,) slices.
    # The per-gp jac buffer is REUSED across Gauss points — a single
    # (8, 3, 3, H) f64 jacobian would first-touch 1.9 GB at 3.3M hexes,
    # and fresh-page faults are the measured bottleneck of large packs.
    dn_mat = np.ascontiguousarray(_HEX_DN.transpose(0, 2, 1))  # (8g, 3a, 8l)
    pos_t = positions.transpose(1, 2, 0).reshape(8, 3 * h)

    grads = np.empty((8, 8, 3, h), dtype)
    det = np.empty((8, h))
    dn = _HEX_DN.astype(dtype)
    # inv_t[a, b] = (J^-1)[b, a] per gp; assignments cast f64 -> dtype
    inv_t = np.empty((3, 3, h), dtype)
    jac_g = np.empty((3, 3 * h))
    for g in range(8):
        np.matmul(dn_mat[g], pos_t, out=jac_g)
        a = jac_g.reshape(3, 3, h)  # contiguous component streams
        i00 = a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1]
        i10 = a[1, 2] * a[2, 0] - a[1, 0] * a[2, 2]
        i20 = a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]
        d = a[0, 0] * i00 + a[0, 1] * i10 + a[0, 2] * i20
        det[g] = d
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_d = 1.0 / d  # degenerate cells error in run()
        # inv_t[a, b] = adj(J)[b, a] / det = (J^-1)[b, a]
        inv_t[0, 0] = i00 * inv_d
        inv_t[0, 1] = i10 * inv_d
        inv_t[0, 2] = i20 * inv_d
        inv_t[1, 0] = (a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2]) * inv_d
        inv_t[1, 1] = (a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0]) * inv_d
        inv_t[1, 2] = (a[0, 1] * a[2, 0] - a[0, 0] * a[2, 1]) * inv_d
        inv_t[2, 0] = (a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]) * inv_d
        inv_t[2, 1] = (a[0, 2] * a[1, 0] - a[0, 0] * a[1, 2]) * inv_d
        inv_t[2, 2] = (a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]) * inv_d
        # grad[l, b] = sum_a dN[g, l, a] (J^-1)[b, a] = dN[g] @ inv_t
        grads[g] = (dn[g] @ inv_t.reshape(3, 3 * h)).reshape(8, 3, h)
    return grads, det


def hex_gradients(positions: np.ndarray) -> tuple:
    """Element-major view of :func:`hex_gradients_gp_major`.

    positions: (H, 8, 3).  Returns (gradients (H, 8gp, 8node, 3),
    point_volume (H, 8gp)).  2x2x2 Gauss with unit weights, so the point
    volume is detJ at the Gauss point and they sum to the element volume.
    Kept for small-batch callers (structured-grid constant tables, tests).
    """
    grads, det = hex_gradients_gp_major(positions)
    return grads.transpose(3, 0, 1, 2), det.T


def run(mesh: Mesh, cfg: Config) -> PreprocessOutputs:
    """Full preprocessing pipeline (preprocess.cpp:284-404)."""
    if mesh.node_count == 0:
        raise PreprocessError("mesh has zero nodes", ["mesh"])
    if mesh.element_count == 0:
        raise PreprocessError("mesh has zero elements", ["mesh"])

    _check_duplicate_nodes(mesh)
    _check_duplicate_elements(mesh)
    _validate_config_groups(mesh, cfg)
    binding = bind_materials(mesh, cfg)

    n_nodes = mesh.node_count
    n_elems = mesh.element_count

    if (mesh.elements >= n_nodes).any():
        bad = int(np.argwhere(mesh.elements >= n_nodes)[0][0])
        raise PreprocessError(
            "element references node out of range", ["elements", f"[{bad}]"]
        )

    # material binding per element (preprocess.cpp:362-369)
    element_material = np.full(n_elems, -1, dtype=np.int32)
    for group_id, mat_index in binding.items():
        element_material[mesh.element_physical_group == group_id] = mat_index
    if (element_material < 0).any():
        bad = int(np.argmax(element_material < 0))
        raise PreprocessError(
            "element physical group missing assignment", ["elements", f"[{bad}]"]
        )

    densities = np.array([mat.density for mat in cfg.materials], dtype=np.float64)

    is_tet = mesh.element_node_counts == 4
    is_hex = mesh.element_node_counts == 8
    tet_idx = np.nonzero(is_tet)[0]
    hex_idx = np.nonzero(is_hex)[0]

    element_volumes = np.zeros(n_elems, dtype=np.float64)
    lumped_mass = np.zeros(n_nodes, dtype=np.float64)

    t = tet_idx.size
    tet_conn = mesh.elements[tet_idx] if t else np.zeros((0, 8), np.int32)
    tet_grads = np.zeros((t, 4, 3))
    tet_vol = np.zeros(t)
    if t:
        positions = mesh.node_positions[tet_conn[:, :4]]
        tet_grads, tet_vol = tet_gradients(positions)
        if (tet_vol <= np.finfo(np.float64).eps).any():
            bad = int(tet_idx[np.argmax(tet_vol <= np.finfo(np.float64).eps)])
            raise PreprocessError(
                "tetrahedron volume non-positive", ["elements", f"[{bad}]"]
            )
        element_volumes[tet_idx] = tet_vol
        # lumped mass rho * V / 4 per corner (preprocess.cpp:370-375);
        # bincount replaces np.add.at (buffered ufunc.at is ~20x slower
        # at millions of entries)
        rho = densities[element_material[tet_idx]]
        lump = rho * tet_vol / 4.0
        lumped_mass += np.bincount(
            tet_conn[:, :4].reshape(-1).astype(np.int64),
            weights=np.repeat(lump, 4),
            minlength=n_nodes,
        )

    h = hex_idx.size
    hex_conn = mesh.elements[hex_idx] if h else np.zeros((0, 8), np.int32)
    hex_grads = np.zeros((8, 8, 3, h), np.float32)
    hex_detj = np.zeros((8, h))
    if h:
        positions = mesh.node_positions[hex_conn]
        hex_grads, hex_detj = hex_gradients_gp_major(
            positions, dtype=np.float32
        )
        if (hex_detj <= np.finfo(np.float64).eps).any():
            bad = int(
                hex_idx[
                    np.argmax(
                        (hex_detj <= np.finfo(np.float64).eps).any(axis=0)
                    )
                ]
            )
            raise PreprocessError(
                "hexahedron Jacobian non-positive", ["elements", f"[{bad}]"]
            )
        volume = hex_detj.sum(axis=0)
        element_volumes[hex_idx] = volume
        rho = densities[element_material[hex_idx]]
        lump = rho * volume / 8.0
        lumped_mass += np.bincount(
            hex_conn.reshape(-1).astype(np.int64),
            weights=np.repeat(lump, 8),
            minlength=n_nodes,
        )

    return PreprocessOutputs(
        element_volumes=element_volumes,
        element_material_index=element_material,
        tet_connectivity=np.asarray(tet_conn, np.int32),
        tet_gradients=tet_grads,
        tet_volume=tet_vol,
        tet_material=element_material[tet_idx].astype(np.int32),
        tet_elements=tet_idx.astype(np.int64),
        hex_connectivity=np.asarray(hex_conn, np.int32),
        hex_gradients_gp=hex_grads,
        hex_detj=hex_detj,
        hex_material=element_material[hex_idx].astype(np.int32),
        hex_elements=hex_idx.astype(np.int64),
        lumped_mass=lumped_mass,
        node_count=n_nodes,
    )


def _build_adjacency(quad_conn: np.ndarray, n_nodes: int) -> NodeAdjacency:
    """CSR node -> (row, slot) adjacency, vectorized (preprocess.cpp:378-401)."""
    q, slots = quad_conn.shape
    flat = quad_conn.reshape(-1)
    valid = flat != SENTINEL
    nodes = flat[valid].astype(np.int64)
    rows = np.repeat(np.arange(q, dtype=np.int64), slots)[valid]
    locals_ = np.tile(np.arange(slots, dtype=np.int8), q)[valid]
    order = np.argsort(nodes, kind="stable")
    counts = np.bincount(nodes, minlength=n_nodes)
    offsets = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return NodeAdjacency(
        offsets=offsets, row_indices=rows[order], local_indices=locals_[order]
    )
