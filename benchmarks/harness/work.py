"""Least work of the kernels whose roofline share the benchmark reports,
counted from the mesh's shapes, and the card's published peaks.

The counts follow the program's kernel table (PERF.md): each input byte
read once and each output byte written once, f32 values, 1-byte masks.

* ``pc_keff`` (K2, the fused preconditioned operator with its dots) on a
  structured grid of N nodes: reads x (12 B) and the mask (3 B), writes
  two vectors (24 B): 39 B and 531 operations per node.
* ``tet_element_forces`` (K7 on tet4) over E tets and N nodes: per tet the
  connectivity (16 B), shape gradients (48 B), volume, lambda and mu
  (12 B) read and four force rows (48 B) written; per node x (12 B) and
  the mask (3 B) read: 124 B per tet, 15 B per node, 171 operations per
  tet.
* ``assemble_tet`` (G1, the gather of the force rows into K_eff x with
  the mass and identity rows) over the 4 E incidences of a tet mesh: per
  incidence its row index and weight (8 B) and force row (12 B) read; per
  node the mass (4 B), x (12 B) and mask (3 B) read and the result
  (12 B) written: 20 B and 6 operations per incidence, 31 B and 7 per
  node.
* ``pcg_update`` (U1, the fused PCG loop's direction update) on a
  structured grid of N nodes: six f32 3-vectors read (x, r, p, s, u, w:
  72 B) and four written (x, r, p, s: 48 B), the 1-byte mask per
  component (3 B): 123 B and 24 operations per node (the p and s
  recurrences and the x and r axpys, a product and a sum each).  A
  solve's first update reads no p and s and computes no recurrence: 99 B
  and 12 operations per node.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published device-memory bandwidth, 700 W
F32_FLOPS_PER_S = 67.0e12  # H100 SXM published f32 rate outside the tensor cores


def least_seconds(nbytes: float, flops: float) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the f32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def pc_keff(box) -> tuple:
    n = box.node_count
    return 39 * n, 531 * n


def pcg_update(box, first: bool = False) -> tuple:
    n = box.node_count
    return (99 * n, 12 * n) if first else (123 * n, 24 * n)


def _tets(box) -> int:
    if box.element != "tet4":
        raise ValueError(f"a tet4 count of a {box.element} mesh")
    return 6 * box.cell_count


def tet_element_forces(box) -> tuple:
    e, n = _tets(box), box.node_count
    return 124 * e + 15 * n, 171 * e


def assemble_tet(box) -> tuple:
    incidences, n = 4 * _tets(box), box.node_count
    return 20 * incidences + 31 * n, 6 * incidences + 7 * n
