"""In-memory mesh model (array-of-structs replaced by numpy SoA).

Copy of :mod:`civiwave_tpu.mesh.model`, which mirrors ``cwf::mesh::Mesh``
(the reference engine's include/cwf/mesh/mesh.hpp:116-127) but stores
nodes/elements/surfaces as numpy arrays from the start — the pipeline
consumes columnar data, so there is no per-object ``Node``/``Element``
layer to shred later.

Conventions:
* ``elements`` is (E, 8) int32 with ``-1`` padding (the reference pads with
  ``UINT32_MAX`` sentinels, mesh.cpp:346); ``element_node_counts`` gives the
  true arity (4 = tet4, 8 = hex8).
* ``surfaces`` is (S, 4) int32 with ``-1`` padding (3 = tri3, 4 = quad4).
* physical groups mirror mesh.hpp:
  ``node_groups``/``surface_groups`` map group id -> member indices, and
  ``physical_groups`` lists (dimension, id, name).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

SENTINEL = -1  # padding marker for unused connectivity slots


@dataclass(frozen=True)
class PhysicalGroup:
    """Named physical group (mesh.hpp PhysicalGroup)."""

    dimension: int
    id: int
    name: str


@dataclass
class Mesh:
    """Parsed mesh: columnar nodes/elements/surfaces plus group indices."""

    # nodes
    node_positions: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), dtype=np.float64)
    )
    node_original_ids: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), dtype=np.int64)
    )

    # volume elements (tet4 / hex8)
    elements: np.ndarray = field(default_factory=lambda: np.zeros((0, 8), dtype=np.int32))
    element_node_counts: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), dtype=np.int32)
    )
    element_physical_group: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), dtype=np.int64)
    )
    element_original_ids: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), dtype=np.int64)
    )

    # surface elements (tri3 / quad4)
    surfaces: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), dtype=np.int32))
    surface_node_counts: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), dtype=np.int32)
    )
    surface_physical_group: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), dtype=np.int64)
    )
    surface_original_ids: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), dtype=np.int64)
    )

    # group indices
    physical_groups: List[PhysicalGroup] = field(default_factory=list)
    group_lookup: Dict[int, int] = field(default_factory=dict)  # id -> index in physical_groups
    node_groups: Dict[int, np.ndarray] = field(default_factory=dict)  # id -> node indices
    surface_groups: Dict[int, np.ndarray] = field(default_factory=dict)  # id -> surface indices

    @property
    def node_count(self) -> int:
        return int(self.node_positions.shape[0])

    @property
    def element_count(self) -> int:
        return int(self.elements.shape[0])

    @property
    def dof_count(self) -> int:
        return self.node_count * 3

    def group_name_to_id(self) -> Dict[str, int]:
        """Name -> group id lookup used by loads/Dirichlet binding."""
        return {group.name: group.id for group in self.physical_groups}
