"""Lysmer-Kuhlemeyer absorbing boundaries (viscous dashpots) of the general
path.

Port of :mod:`civiwave_tpu.physics.absorbing`.  The traction

    t = -rho * c_p * v_n * n  -  rho * c_s * v_t

is a per-unit-area dashpot c_p = sqrt((lam + 2 mu) / rho) against the
normal velocity and c_s = sqrt(mu / rho) against the tangential one.
Lumped per node with tributary face areas, the damping matrix is
block-diagonal with symmetric 3x3 node blocks

    C_node = rho * A_node * (c_p n n^T + c_s (I - n n^T))

which enters the implicit Newmark system like the Rayleigh terms:
K_eff += a1 * C and rhs += C (a1 u + a4 v + a5 a).

:func:`assemble_dashpots` is host numpy (a copy of the reference's, like
``loads.assemble_load_vector``), from the YAML ``boundaries: absorbing:
[group, ...]`` surface groups; the material of each face is that of an
element incident to its first corner node.  :func:`sym_apply` is the
operator's per-node product on (N*, 6) packed blocks, for numpy arrays and
torch tensors alike.  The structured route has its own face form
(``ops/structured.py``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config.schema import Config
from ..mesh.model import Mesh
from ..mesh.preprocess import PreprocessOutputs
from . import materials as materials_mod

_SYM_IDX = [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]


def wave_speeds(lam: float, mu: float, rho: float) -> tuple[float, float]:
    """(c_p, c_s) for an isotropic material."""
    return (np.sqrt((lam + 2.0 * mu) / rho), np.sqrt(mu / rho))


def sym_pack(blocks: np.ndarray) -> np.ndarray:
    """(N, 3, 3) symmetric blocks -> (N, 6) packed [00,11,22,01,02,12]."""
    return np.stack([blocks[:, i, j] for i, j in _SYM_IDX], axis=1)


def sym_apply(packed, v):
    """z = C v for sym-packed (..., 6) blocks against (..., 3) vectors, in
    the reference's order of operations; numpy arrays or torch tensors."""
    c00, c11, c22, c01, c02, c12 = (packed[..., m] for m in range(6))
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    rows = [
        c00 * v0 + c01 * v1 + c02 * v2,
        c01 * v0 + c11 * v1 + c12 * v2,
        c02 * v0 + c12 * v1 + c22 * v2,
    ]
    if isinstance(v, torch.Tensor):
        return torch.stack(rows, dim=-1)
    return np.stack(rows, axis=-1)


def _node_material_map(mesh: Mesh, pre: PreprocessOutputs) -> np.ndarray:
    """(N,) material index of SOME element incident to each node (boundary
    faces normally border a single outer material)."""
    node_mat = np.zeros(mesh.node_count, dtype=np.int32)
    if pre.tet_count:
        conn = pre.tet_connectivity[:, :4]
        node_mat[conn.reshape(-1)] = np.repeat(pre.tet_material, 4)
    if pre.hex_count:
        conn = pre.hex_connectivity
        node_mat[conn.reshape(-1)] = np.repeat(pre.hex_material, 8)
    return node_mat


def assemble_dashpots(
    mesh: Mesh,
    pre: PreprocessOutputs,
    cfg: Config,
    props: Sequence[materials_mod.ElasticProperties],
) -> np.ndarray | None:
    """(N, 6) sym-packed f64 dashpot blocks, or None when the scenario
    declares no absorbing groups.

    Face normals come from the cross product of the face edges (the sign is
    irrelevant: C depends on n only through n n^T); tributary areas use the
    equal-nodal-share rule of the traction assembly, a quad being two
    triangles.
    """
    if not cfg.absorbing:
        return None
    n = mesh.node_count
    blocks = np.zeros((n, 3, 3), dtype=np.float64)
    name_to_group = mesh.group_name_to_id()
    densities = [m.density for m in cfg.materials]
    pos = mesh.node_positions
    node_mat = _node_material_map(mesh, pre)

    for group in cfg.absorbing:
        group_id = name_to_group.get(group)
        if group_id is None:
            raise ValueError(
                f"absorbing group '{group}' not found in mesh physical groups"
            )
        surface_indices = mesh.surface_groups.get(group_id)
        if surface_indices is None:
            raise ValueError(
                f"absorbing group '{group}' has no surface elements"
            )
        conn = mesh.surfaces[surface_indices]
        counts = mesh.surface_node_counts[surface_indices]
        for face, count in zip(conn, counts):
            nodes = face[:count]
            v1 = pos[nodes[1]] - pos[nodes[0]]
            v2 = pos[nodes[2]] - pos[nodes[0]]
            cr = np.cross(v1, v2)
            area = 0.5 * np.linalg.norm(cr)
            if count == 4:
                v3 = pos[nodes[3]] - pos[nodes[0]]
                cr2 = np.cross(v2, v3)
                area += 0.5 * np.linalg.norm(cr2)
            norm = np.linalg.norm(cr)
            if norm < 1.0e-30 or area <= 0.0:
                continue
            normal = cr / norm
            mat = int(node_mat[int(nodes[0])])
            lam, mu = props[mat].lame.lam, props[mat].lame.mu
            rho = densities[mat]
            c_p, c_s = wave_speeds(lam, mu, rho)
            nnt = np.outer(normal, normal)
            c_block = rho * (c_p * nnt + c_s * (np.eye(3) - nnt))
            share = area / count
            for node in nodes:
                blocks[node] += share * c_block
    return sym_pack(blocks)


def dense_damping_matrix(packed: np.ndarray) -> np.ndarray:
    """(N, 6) packed blocks -> dense (3N, 3N) block-diagonal C for the
    oracle."""
    n = packed.shape[0]
    dense = np.zeros((3 * n, 3 * n), dtype=np.float64)
    for m, (i, j) in enumerate(_SYM_IDX):
        idx = np.arange(n)
        dense[3 * idx + i, 3 * idx + j] += packed[:, m]
        if i != j:
            dense[3 * idx + j, 3 * idx + i] += packed[:, m]
    return dense
