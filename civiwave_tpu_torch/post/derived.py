"""Derived fields: strain, stress, von Mises per element and per node.

Copy of :mod:`civiwave_tpu.post.derived` (host numpy), a rebuild of the
reference engine's src/post/derived_fields.cpp:139-211.  Per quadrature row: Voigt strain eps = sum_l grad_l . u_l (engineering shear,
derived_fields.cpp:166-188), stress = D . eps (derived_fields.cpp:69-83),
von Mises (derived_fields.cpp:51-67).  Node fields are volume-weighted
averages over incident rows (derived_fields.cpp:193-207); element fields for
hex8 are volume-weighted averages over the element's 8 Gauss rows (the
reference had one row per element, tet-only).

Von Mises is computed from the *averaged* stress at nodes, matching
finalize_node (derived_fields.cpp:113-135).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..mesh.model import SENTINEL
from ..mesh.preprocess import PreprocessOutputs


@dataclass
class DerivedFieldSet:
    """Element + node tensors (derived_fields.hpp:38-65), float32 like the
    reference's packed outputs."""

    element_strain: np.ndarray  # (E, 6)
    element_stress: np.ndarray  # (E, 6)
    element_von_mises: np.ndarray  # (E,)
    node_strain: np.ndarray  # (N, 6)
    node_stress: np.ndarray  # (N, 6)
    node_von_mises: np.ndarray  # (N,)


def von_mises(stress: np.ndarray) -> np.ndarray:
    """sqrt(0.5 sum (s_i - s_j)^2 + 3 sum tau^2) (derived_fields.cpp:51-67)."""
    sx, sy, sz = stress[..., 0], stress[..., 1], stress[..., 2]
    txy, tyz, txz = stress[..., 3], stress[..., 4], stress[..., 5]
    energy = 0.5 * (
        (sx - sy) ** 2 + (sy - sz) ** 2 + (sz - sx) ** 2
    ) + 3.0 * (txy**2 + tyz**2 + txz**2)
    return np.sqrt(np.maximum(energy, 0.0))


def compute_derived_fields(
    preprocess: PreprocessOutputs,
    stiffness_6x6: np.ndarray,  # (M, 6, 6)
    displacement: np.ndarray,  # (N, 3)
    node_count: int,
    element_count: int,
) -> DerivedFieldSet:
    """Strain/stress/von-Mises fields (derived_fields.cpp:139-211)."""
    conn = preprocess.quad_connectivity  # (Q, 8)
    grads = preprocess.quad_gradients  # (Q, 8, 3)
    vol = preprocess.quad_volume  # (Q,)
    u = np.asarray(displacement, dtype=np.float64)[:node_count]

    conn_safe = np.where(conn == SENTINEL, 0, conn)
    u_e = u[conn_safe]  # (Q, 8, 3); sentinel slots have zero gradients
    g_tensor = np.einsum("qla,qlb->qab", grads, u_e)  # du_b/dx_a

    strain = np.stack(
        [
            g_tensor[:, 0, 0],
            g_tensor[:, 1, 1],
            g_tensor[:, 2, 2],
            g_tensor[:, 1, 0] + g_tensor[:, 0, 1],
            g_tensor[:, 2, 1] + g_tensor[:, 1, 2],
            g_tensor[:, 2, 0] + g_tensor[:, 0, 2],
        ],
        axis=-1,
    )  # (Q, 6) with engineering shear

    d_rows = np.asarray(stiffness_6x6, dtype=np.float64)[
        preprocess.quad_material_index
    ]  # (Q, 6, 6)
    stress = np.einsum("qij,qj->qi", d_rows, strain)

    # element aggregation: volume-weighted over the element's quadrature rows
    elem_strain = np.zeros((element_count, 6))
    elem_stress = np.zeros((element_count, 6))
    elem_weight = np.zeros(element_count)
    np.add.at(elem_strain, preprocess.quad_element, strain * vol[:, None])
    np.add.at(elem_stress, preprocess.quad_element, stress * vol[:, None])
    np.add.at(elem_weight, preprocess.quad_element, vol)
    safe_w = np.where(elem_weight > 0.0, elem_weight, 1.0)[:, None]
    elem_strain /= safe_w
    elem_stress /= safe_w

    # node aggregation: each row scatters (value * row volume) to its nodes
    node_strain = np.zeros((node_count, 6))
    node_stress = np.zeros((node_count, 6))
    node_weight = np.zeros(node_count)
    valid = conn != SENTINEL
    rows, slots = np.nonzero(valid)
    nodes = conn[rows, slots]
    np.add.at(node_strain, nodes, strain[rows] * vol[rows, None])
    np.add.at(node_stress, nodes, stress[rows] * vol[rows, None])
    np.add.at(node_weight, nodes, vol[rows])
    safe_nw = np.where(node_weight > 0.0, node_weight, 1.0)[:, None]
    node_strain /= safe_nw
    node_stress /= safe_nw
    zero_nodes = node_weight <= 0.0
    node_strain[zero_nodes] = 0.0
    node_stress[zero_nodes] = 0.0

    return DerivedFieldSet(
        element_strain=elem_strain.astype(np.float32),
        element_stress=elem_stress.astype(np.float32),
        element_von_mises=von_mises(elem_stress).astype(np.float32),
        node_strain=node_strain.astype(np.float32),
        node_stress=node_stress.astype(np.float32),
        node_von_mises=von_mises(node_stress).astype(np.float32),
    )
