"""Bandwidth-reducing node renumbering (reverse Cuthill-McKee).

Port of :mod:`civiwave_tpu.mesh.renumber`, cut to RCM.  Real Gmsh output is
often numbered far from bandwidth-optimal.  On the card the element kernel
gathers each element's corner rows of x and the assembly kernel gathers
each node's force rows; both run through L2, so a numbering whose elements
span few node ids keeps the gathered rows of neighbouring threads in the
same cache lines.  Pack renumbers nodes with RCM when that tightens the
element spans, and inverse-permutes at the host-facing edges
(``PackedModel.to_nodal``/``from_nodal``).

Left out (ROADMAP "Do not port"): the coordinate-lexicographic
``plan_geometric`` and the offset-pattern (oct) feasibility checks, which
exist only to re-enable the TPU's oct gathers.

The node graph is the FEM connectivity graph: nodes adjacent iff they
share an element, built sparsely as ``B.T @ B`` from the (E, nl)
element-node incidence; scipy's ``reverse_cuthill_mckee`` orders it.

Decision, deliberately different from the reference: RCM is taken when its
(max element span, sum of element spans) is lexicographically smaller than
the native numbering's — the rule the reference's docstring states.  The
reference itself compares the max span only, behind a halving rule
(civiwave_tpu/mesh/renumber.py:198-206), so the two packages may pick
different internal orders; results are compared in nodal order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def element_spans(
    conn_blocks: Sequence[np.ndarray], perm: Optional[np.ndarray] = None
) -> Tuple[int, int]:
    """(max, sum) of per-element corner-id spans under ``perm`` (identity
    when None).  Lower is better."""
    worst = 0
    total = 0
    for conn in conn_blocks:
        if conn is None or not len(conn):
            continue
        c = perm[conn] if perm is not None else conn
        spans = c.max(axis=1) - c.min(axis=1)
        worst = max(worst, int(spans.max()))
        total += int(spans.sum())
    return worst, total


def plan_rcm(
    conn_blocks: Sequence[np.ndarray], node_count: int
) -> Optional[np.ndarray]:
    """RCM permutation ``perm[old_id] = new_id`` over the FEM node graph,
    or None when scipy is unavailable or the mesh has no elements."""
    try:
        from scipy import sparse
        from scipy.sparse.csgraph import reverse_cuthill_mckee
    except ImportError:
        return None
    rows_l = []
    cols_l = []
    e_total = 0
    for conn in conn_blocks:
        if conn is None or not len(conn):
            continue
        e, nl = conn.shape
        rows_l.append(
            np.repeat(np.arange(e_total, e_total + e, dtype=np.int64), nl)
        )
        cols_l.append(conn.reshape(-1).astype(np.int64))
        e_total += e
    if not e_total:
        return None
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    incidence = sparse.coo_matrix(
        (np.ones(len(rows), dtype=np.int32), (rows, cols)),
        shape=(e_total, node_count),
    ).tocsr()
    adjacency = (incidence.T @ incidence).tocsr()
    order = reverse_cuthill_mckee(adjacency, symmetric_mode=True)
    perm = np.empty(node_count, dtype=np.int64)
    perm[np.asarray(order, dtype=np.int64)] = np.arange(
        node_count, dtype=np.int64
    )
    return perm


def plan_renumbering(
    conn_blocks: Sequence[np.ndarray], node_count: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(perm, inverse_perm) when RCM's (max, sum) element span is
    lexicographically smaller than the native numbering's, else None (keep
    the mesh's native order).

    ``perm[old_id] = new_id``; ``inverse_perm[new_id] = old_id``.
    Deterministic in the mesh alone.
    """
    if node_count <= 1:
        return None
    native = element_spans(conn_blocks)
    if native[0] <= 0:
        return None
    perm = plan_rcm(conn_blocks, node_count)
    if perm is None:
        return None
    if element_spans(conn_blocks, perm) >= native:
        return None
    return perm, np.argsort(perm)
