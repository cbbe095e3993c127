"""Structured-grid operators in component-separated (3, X, Y, Z) layout.

Port of :mod:`civiwave_tpu.ops.structured`.  Same math as the
unstructured hex path (2x2x2 Gauss, tensor-form isotropic stress).

For a uniform homogeneous grid the assembled interior operator is a
constant 27-tap stencil of 3x3 blocks: ``out[b][n] = sum_d sum_c
C[d][b][c] * u[c][n+d]``.  The constant stencil assumes full element
coverage; the plain form recovers the exact operator by inclusion-exclusion
boundary corrections (ghost face slabs, edge beams and corner cells are
lower-dimensional constant stencils applied to the boundary planes):

    real = full - (sum faces - sum edges + sum corners)

The CUDA kernels (``ops/cuda``) evaluate the same operator from one
*per-boundary-class* table instead (:func:`class_stencil_table`): a node's
stencil depends only on whether it sits on the low face, in the interior
or on the high face of each axis, so 27 classes x 27 offsets of 3x3 blocks
carry every node's exact taps and no correction pass is needed.

Constrained rows (Dirichlet, dead +X pad planes) use the sanitize /
identity-row envelope: ``bc ? x : ss * K(xs) + mf * mass * xs`` with
``xs = where(bc, 0, x)``, written by select so constrained outputs keep the
input's sign (+0.0 stays +0.0).

Dispatch is on the tensor's device: a CUDA tensor goes to the kernel
wrapper, a CPU tensor to the plain version.  f64 vectors
(``precision.vectors: fp64``) take the f64 instances of K1/K5 and K3 on
CUDA; K2, K4, K6 and G2 are f32 only, as the reference's kernels, so an f64
vector composes K3 and K1 where f32 would take K2, and a slender grid
takes K1.  The grid's shape picks the form, as in the reference:

* every grid takes the complete operator K1, except
* large slender members (more than 700,000 nodes and a (Y, Z) plane under
  5,000 nodes, f32 vectors: :func:`slender_route`), which take the split
  form of the reference's ``_interior_dispatch``: the interior stencil K4
  on the sanitized vector, then G2, which subtracts each boundary node's
  ghost taps (from the class table, :func:`ghost_stencil_table`) and adds
  the scale, the mass term and the identity rows.  There the fused K2
  and K6 decline and 'auto' PCG is classic.

A heterogeneous grid (per-cell ``lam_grid``/``mu_grid``, ``homogeneous``
False) takes the corner-gather element loop instead: each cell's 8 corner
values, its Gauss-point strains and stresses with the cell's own material,
and the 8 corner forces scattered back (:func:`heterogeneous_stiffness`,
the reference's XLA form).  On CUDA one hand-written kernel, G3
(``ops/cuda/corner_gather.py``), computes the whole ``bc ? x : ss *
K(xs) + mf * mass * xs`` from the stored mass; every homogeneous kernel
(K1, K2, K4 + G2, K6) declines such a grid, 'auto' PCG is classic and the
preconditioner is the per-node packed inverse
(:func:`build_block_jacobi_inverse_structured`, applied by torch ops).

Lysmer-Kuhlemeyer absorbing faces add ``damp_factor * C x`` on their face
planes after the identity rows, on both forms.

The kernels synthesize the lumped mass as ``m8`` times 0.5 per boundary
axis instead of reading ``mass_grid``.  A multigrid coarse level stores
P^T m_f, which differs on a few planes, so it carries a
:class:`MassCorrection` that :func:`apply_keff_structured` adds after the
kernels on CUDA; the plain forms read ``mass_grid`` and need none.  The
multigrid smoother's per-node block-Jacobi apply
(:func:`apply_preconditioner_structured`) is torch ops, as it is XLA in
the reference.

A shard of a multi-device decomposition (a model carrying a
``shard_group``) takes the sharded operator instead
(``ops/structured_sharded.py``: ghost exchange + K5), whatever its shape;
the preconditioner is K3 with the shard's global offsets, and K2 and K6
decline, so PCG composes the two and reduces its dots across the group.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..mesh.structured import CORNERS, StructuredModel
from .cuda import _build as _cuda_build
from .cuda import block_jacobi_apply as _k3
from .cuda import corner_gather as _g3
from .cuda import interior_stencil as _k4
from .cuda import keff_boundary as _g2
from .cuda import pcg_iteration as _k6
from .cuda import structured_stencil as _k12
from .cuda.plane_sweep import FACTORED_TAPS

_DET_TOL = 1.0e-12


# --------------------------------------------------------------------------
# constant tables (numpy, cached per spacing/material)
# --------------------------------------------------------------------------


@lru_cache(maxsize=32)
def _element_tables(spacing: Tuple[float, float, float]):
    """Constant Gauss gradient table for one uniform cell: (8gp, 8l, 3), (8,)."""
    from ..mesh.preprocess import hex_gradients

    corner = np.array(CORNERS, np.float64) * np.asarray(spacing, np.float64)
    grads, gp_vol = hex_gradients(corner[None])
    return grads[0], gp_vol[0]


@lru_cache(maxsize=32)
def _pair_matrices(spacing: Tuple[float, float, float]):
    """Constant 24x24 per-element operators: K_e = lam*Klam + mu*Kmu.

    Klam[l,b,m,c] = sum_gp V g[gp,l,b] g[gp,m,c]              (volumetric)
    Kmu[l,b,m,c]  = d_bc sum_gp V g[gp,l,:].g[gp,m,:]
                    + sum_gp V g[gp,l,c] g[gp,m,b]            (deviatoric)
    """
    grads, gp_vol = _element_tables(spacing)
    klam = np.einsum("g,glb,gmc->lbmc", gp_vol, grads, grads)
    kmu1 = np.einsum("g,gla,gma->lm", gp_vol, grads, grads)
    kmu = np.zeros((8, 3, 8, 3))
    for b in range(3):
        kmu[:, b, :, b] += kmu1
    kmu += np.einsum("g,glc,gmb->lbmc", gp_vol, grads, grads)
    return klam, kmu


def _restricted_stencil(kfull: np.ndarray, fixed: Dict[int, int]) -> np.ndarray:
    """Assembled stencil over corner pairs restricted to fixed axis slots.

    ``fixed[axis] = s`` keeps only pairs with both corners at slot ``s`` on
    that axis (s=1: the ghost slab sits on the low side of the plane, s=0:
    high side).  Free axes become tap dims indexed by (offset + 1), where
    offset = corner_m - corner_l (input node relative to output node).
    Returns taps of shape (3,)*len(free) + (3, 3).
    """
    free = [a for a in range(3) if a not in fixed]
    out = np.zeros((3,) * len(free) + (3, 3))
    for l, cl in enumerate(CORNERS):
        for m, cm in enumerate(CORNERS):
            if any(cl[a] != s or cm[a] != s for a, s in fixed.items()):
                continue
            idx = tuple(cm[a] - cl[a] + 1 for a in free)
            out[idx] += kfull[l, :, m, :]
    return out


@lru_cache(maxsize=32)
def _stencil_tables(spacing, lam0: float, mu0: float):
    """All constant stencils for a homogeneous grid (see module docstring)."""
    klam, kmu = _pair_matrices(spacing)
    kfull = lam0 * klam + mu0 * kmu
    faces = {}
    edges = {}
    corners = {}
    for axis in range(3):
        for side in (0, 1):  # 0 = low boundary plane, 1 = high
            faces[(axis, side)] = _restricted_stencil(kfull, {axis: 1 - side})
    for a1 in range(3):
        for a2 in range(a1 + 1, 3):
            for s1 in (0, 1):
                for s2 in (0, 1):
                    edges[(a1, s1, a2, s2)] = _restricted_stencil(
                        kfull, {a1: 1 - s1, a2: 1 - s2}
                    )
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                corners[(sx, sy, sz)] = _restricted_stencil(
                    kfull, {0: 1 - sx, 1: 1 - sy, 2: 1 - sz}
                )
    interior = _restricted_stencil(kfull, {})
    return interior, faces, edges, corners


# local corner slots a node may occupy in its incident cells, per axis
# boundary class: low face (0) is slot 0 of the cell above it, high face (2)
# slot 1 of the cell below, interior (1) both
_CLASS_SLOTS = {0: (0,), 1: (0, 1), 2: (1,)}


@lru_cache(maxsize=32)
def _class_stencil_table64(spacing, lam0: float, mu0: float) -> np.ndarray:
    """:func:`class_stencil_table` in f64, shape (27, 27, 3, 3)."""
    klam, kmu = _pair_matrices(tuple(spacing))
    kfull = lam0 * klam + mu0 * kmu
    table = np.zeros((3, 3, 3, 3, 3, 3, 3, 3))
    for cls in np.ndindex(3, 3, 3):
        for l, cl in enumerate(CORNERS):
            if any(cl[a] not in _CLASS_SLOTS[cls[a]] for a in range(3)):
                continue
            for m, cm in enumerate(CORNERS):
                d = tuple(cm[a] - cl[a] + 1 for a in range(3))
                table[cls + d] += kfull[l, :, m, :]
    return table.reshape(27, 27, 3, 3)


def class_stencil_table(spacing, lam0: float, mu0: float) -> np.ndarray:
    """Per-boundary-class assembled stencil, (27, 27, 3, 3) f32.

    ``table[(cx*3+cy)*3+cz, ((dx+1)*3+(dy+1))*3+(dz+1)][b, c]`` is the
    exact 3x3 tap coupling input component c at node n+d to output
    component b at a node of class (cx, cy, cz): the sum of ``kfull[l, :,
    m, :]`` over the corner pairs (l, m) with offset cm - cl = d whose
    output corner l sits in a slot the class allows on every axis.  It
    equals the interior stencil minus the inclusion-exclusion corrections
    of :func:`_stencil_tables` node by node.  A node's class on an axis of
    n cells at index i is 0 at i == 0, 2 at i >= n (the +X dead pad planes
    land there; they are constrained, so their taps are never used) and 1
    otherwise; n == 1 has no interior class.
    """
    table = _class_stencil_table64(tuple(spacing), lam0, mu0)
    return np.ascontiguousarray(table.astype(np.float32))


@lru_cache(maxsize=32)
def ghost_stencil_table(spacing, lam0: float, mu0: float) -> np.ndarray:
    """Per-boundary-class ghost taps, (27, 27, 3, 3) f32: the interior
    stencil minus the class's own (``ghost[cls] = interior -
    class_stencil_table[cls]``, taken in f64).  They couple a node to its
    neighbours through cells that do not exist, so ``interior(xs) - ghost
    taps . xs`` is the exact stencil at every node; the row of the
    interior class (1, 1, 1), index 13, is zero.  Read by G2 (``keff_boundary``) after K4."""
    interior = _stencil_tables(tuple(spacing), lam0, mu0)[0].reshape(27, 3, 3)
    table = interior[None] - _class_stencil_table64(tuple(spacing), lam0, mu0)
    return np.ascontiguousarray(table.astype(np.float32))


# The interior stencil of a homogeneous isotropic grid of rectangular cells
# is mirror-symmetric on each axis: reflecting axis k multiplies the tap
# [d][b][c] by s_b s_c (s = -1 on component k).  So the diagonal blocks are
# even in dx, dy and dz, the b-c coupling (b != c) is odd along axes b and c
# and even along the third, and 153 of the 243 taps are non-zero in
# structure.  FACTORED_TAPS coefficients hold all of them:
#   [0:24)  diagonal, [b][|dx|][group], group 0 the centre (dy = dz = 0),
#           1 the +-y pair, 2 the +-z pair, 3 the four corners
#   [24:26) x-y coupling at dx = dy = +1, [|dz|]
#   [26:28) x-z coupling at dx = dz = +1, [|dy|]
#   [28:30) y-z coupling at dy = dz = +1, [|dx|]
# (FACTORED_TAPS = 30 of them; the sweeps take SWEEP_TAPS by value, these
# and the z-face ghost taps of :func:`sweep_taps`)
_DIAG_GROUP = ((0, 2), (1, 3))  # [|dy|][|dz|] -> group
_SYMMETRY_RTOL = 1e-12


def expand_factored(coef: np.ndarray) -> np.ndarray:
    """The (3, 3, 3, 3, 3) interior taps [dx+1][dy+1][dz+1][b][c] that
    factored coefficients stand for, in their dtype."""
    coef = np.asarray(coef)
    taps = np.zeros((3, 3, 3, 3, 3), dtype=coef.dtype)
    for d in np.ndindex(3, 3, 3):
        a = [abs(o - 1) for o in d]
        s = [o - 1 for o in d]  # the offset's signs
        for b in range(3):
            taps[d][b, b] = coef[(b * 2 + a[0]) * 4 + _DIAG_GROUP[a[1]][a[2]]]
        taps[d][0, 1] = taps[d][1, 0] = s[0] * s[1] * coef[24 + a[2]]
        taps[d][0, 2] = taps[d][2, 0] = s[0] * s[2] * coef[26 + a[1]]
        taps[d][1, 2] = taps[d][2, 1] = s[1] * s[2] * coef[28 + a[0]]
    return taps


@lru_cache(maxsize=32)
def factored_taps(spacing, lam0: float, mu0: float) -> np.ndarray:
    """The (30,) f64 coefficients (layout at ``FACTORED_TAPS``) of the
    interior row of the class table: each the mean of its taps with their
    signs.  Raises ValueError unless they rebuild every tap of the f64
    interior row, structural zeros included, to 1e-12 of the largest."""
    row = _class_stencil_table64(tuple(spacing), lam0, mu0)[13].reshape(
        3, 3, 3, 3, 3)
    total = np.zeros(FACTORED_TAPS)
    count = np.zeros(FACTORED_TAPS)
    for i in range(FACTORED_TAPS):
        unit = np.zeros(FACTORED_TAPS)
        unit[i] = 1.0
        shape = expand_factored(unit)  # where coefficient i sits, signed
        total[i] = float((shape * row).sum())
        count[i] = float(np.abs(shape).sum())
    coef = total / count
    err = float(np.abs(expand_factored(coef) - row).max())
    if err > _SYMMETRY_RTOL * float(np.abs(row).max()):
        raise ValueError(
            f"the interior stencil at spacing {tuple(spacing)}, lam {lam0}, "
            f"mu {mu0} is not mirror-symmetric: factored taps miss it by "
            f"{err:.3e} of max {float(np.abs(row).max()):.3e}")
    coef.setflags(write=False)
    return coef


def z_face_ghost_taps(coef, table) -> np.ndarray:
    """The (2, 3, 3, 3, 3) f64 ghost taps of the z-face classes (1, 1, 0)
    and (1, 1, 2) at dz = 0, as [side][dx+1][dy+1][b][c]: the interior that
    the factored coefficients ``coef`` give minus those classes' rows of the
    class table ``table`` (27, 27, 3, 3), both taken in f64.  A z-face
    node's stencil differs from the interior one at an in-grid neighbour
    only at dz = 0, so interior minus these taps gives its class row.  The
    one definition of the z-face ghosts: the f32 sweeps' and G2's
    (:func:`sweep_taps`) and the f64 sweeps' (``plane_sweep.sweep_taps64``)."""
    interior = expand_factored(np.asarray(coef, np.float64))[:, :, 1]
    rows = np.asarray(table, np.float64).reshape(27, 3, 3, 3, 3, 3)
    return np.stack([interior - rows[cls][:, :, 1] for cls in (12, 14)])


def sweep_taps(spacing, lam0: float, mu0: float) -> np.ndarray:
    """The (192,) f32 taps the plane-sweep kernels K1/K5, K2 and K6 take
    by value: the interior stencil's factored coefficients
    (:func:`factored_taps`, rounded to f32), then the z-face ghost taps
    (:func:`z_face_ghost_taps` of those coefficients and the f64 class
    table, rounded to f32; G2 takes the same).  A z-face node's stencil
    differs from the interior one at an in-grid neighbour only at dz = 0,
    so interior minus ghost taps give it."""
    coef = factored_taps(tuple(spacing), lam0, mu0).astype(np.float32)
    ghost = z_face_ghost_taps(
        coef, _class_stencil_table64(tuple(spacing), lam0, mu0))
    return np.concatenate([coef, ghost.reshape(-1).astype(np.float32)])


def axis_classes(size: int, cells: int, offset: int = 0) -> np.ndarray:
    """Boundary class (0 low face / 1 interior / 2 high face and beyond) of
    each of ``size`` node positions along an axis of ``cells`` cells,
    starting at global position ``offset`` (a shard's)."""
    idx = np.arange(offset, offset + size)
    return np.where(idx == 0, 0, np.where(idx >= cells, 2, 1))


# --------------------------------------------------------------------------
# plain stencil application (the port of the XLA forms)
# --------------------------------------------------------------------------


def _axpy_rows(rows, window, blk, b_range=range(3)):
    """rows[b] += sum_c f32(blk[b, c]) * window[c], skipping zero taps."""
    for b in b_range:
        for c in range(3):
            w = float(blk[b, c])
            if w == 0.0:
                continue
            term = window[c] * float(np.float32(w))
            rows[b] = term if rows[b] is None else rows[b] + term
    return rows


def _stack_rows(rows, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [r if r is not None else like.new_zeros(shape) for r in rows]
    )


def _apply_taps(v: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Apply a constant block stencil to ``v`` (3, *spatial) with zero-padded
    boundaries; taps has shape (3,)*nd + (3, 3), nd = spatial rank."""
    nd = v.ndim - 1
    vp = F.pad(v, (1, 1) * nd) if nd else v
    spatial = tuple(v.shape[1:])
    rows = [None, None, None]
    for idx in np.ndindex(*taps.shape[:nd]):
        window = vp[(slice(None),) + tuple(
            slice(t, t + s) for t, s in zip(idx, spatial)
        )]
        _axpy_rows(rows, window, taps[idx])
    return _stack_rows(rows, spatial, v)


def _apply_taps_axis(plane: torch.Tensor, taps: np.ndarray, axis_pos: int):
    """Apply a 1D block stencil (taps (3, 3, 3)) along one spatial axis of a
    (3, d1, d2) plane, at every position of the other axis."""
    pad = [0, 0, 0, 0]  # F.pad order: last dim first
    pad[2 * (1 - axis_pos)] = pad[2 * (1 - axis_pos) + 1] = 1
    vp = F.pad(plane, pad)
    size = plane.shape[1 + axis_pos]
    rows = [None, None, None]
    for t in range(3):
        sl = [slice(None)] * plane.ndim
        sl[1 + axis_pos] = slice(t, t + size)
        _axpy_rows(rows, vp[tuple(sl)], taps[t])
    return _stack_rows(rows, tuple(plane.shape[1:]), plane)


def _matvec_const(plane: torch.Tensor, blk: np.ndarray) -> torch.Tensor:
    """Pointwise constant 3x3 matvec over a (3, ...) field."""
    rows = _axpy_rows([None, None, None], plane, blk)
    return _stack_rows(rows, tuple(plane.shape[1:]), plane)


def _onehot(size: int, index: int, like: torch.Tensor) -> torch.Tensor:
    m = torch.zeros(size, dtype=torch.float32, device=like.device)
    m[index] = 1.0
    return m


def _face_correction(model: StructuredModel, xs, axis, side, tables):
    """Correction plane for one face, with its assigned edge/corner terms
    folded in as dense masked ops (one-hot row/point masks)."""
    _, faces, edges, corners = tables
    hi = (model.nx, model.ny, model.nz)
    plane_sl = [slice(None)] * 4
    plane_sl[1 + axis] = 0 if side == 0 else hi[axis]
    plane_sl = tuple(plane_sl)
    plane = xs[plane_sl]  # (3, d1, d2)
    corr = _apply_taps(plane, faces[(axis, side)])
    rem = [a for a in range(3) if a != axis]  # plane's spatial axes
    d1, d2 = plane.shape[1], plane.shape[2]
    # edges assigned to their lower-axis face: sign flips inside corr
    # (out -= corr, so -edge here means +edge in out)
    for (a1, s1, a2, s2), edge_taps in edges.items():
        if a1 != axis or s1 != side:
            continue
        pos = rem.index(a2)  # plane axis the edge line is pinned on
        pinned = 0 if s2 == 0 else hi[a2]
        mask = (
            _onehot(d1, pinned, xs)[None, :, None]
            if pos == 0
            else _onehot(d2, pinned, xs)[None, None, :]
        )
        corr = corr - mask * _apply_taps_axis(plane, edge_taps, 1 - pos)
    # corners assigned to their x face (+corner here -> -corner in out)
    if axis == 0:
        for (sx, sy, sz), corner_taps in corners.items():
            if sx != side:
                continue
            mask = (
                _onehot(d1, 0 if sy == 0 else hi[1], xs)[None, :, None]
                * _onehot(d2, 0 if sz == 0 else hi[2], xs)[None, None, :]
            )
            corr = corr + mask * _matvec_const(plane, corner_taps)
    return plane_sl, corr


def interior_taps(model: StructuredModel) -> np.ndarray:
    """The constant interior stencil (3, 3, 3, 3, 3) f64 that K4 applies."""
    return _stencil_tables(model.spacing, model.lam0, model.mu0)[0]


def subtract_face_corrections(model: StructuredModel, xs, interior):
    """Exact assembled K*xs from the interior stencil's output: the six
    face corrections (edge and corner terms folded into the face buffers)
    subtracted from ``interior`` in place."""
    tables = _stencil_tables(model.spacing, model.lam0, model.mu0)
    for (axis, side) in tables[1]:
        plane_sl, corr = _face_correction(model, xs, axis, side, tables)
        interior[plane_sl] -= corr
    return interior


def keff_envelope(model: StructuredModel, x, xs, stiff, stiffness_scale,
                  mass_factor):
    """scale -> mass term -> identity rows around the stiffness K*xs."""
    out = stiff * float(stiffness_scale)
    out = out + (model.mass_grid.to(x.dtype) * float(mass_factor))[None] * xs
    return torch.where(model.bc_mask, x, out)


def corner_views(model: StructuredModel, grid: torch.Tensor):
    """The eight (..., nx, ny, nz) corner views of a node grid (a CSG
    vector's: the per-corner element views), in CORNERS order."""
    nx, ny, nz = model.nx, model.ny, model.nz
    return [
        grid[..., di : di + nx, dj : dj + ny, dk : dk + nz]
        for (di, dj, dk) in CORNERS
    ]


def heterogeneous_stiffness(model: StructuredModel, xs: torch.Tensor,
                            cells=None):
    """Per-element corner-gather K*xs with the per-cell material grids (CSG
    layout), the reference's ``_apply_heterogeneous_stiffness`` term by
    term: the gradient weights and Gauss volumes rounded to f32 (widened
    for f64 vectors), the same sums in the same order, and the 8 corner
    forces scattered back by slice adds.  ``cells``: the (lam, mu) cell
    grids of xs's nodes, (n0, n1, n2) cells on (n0 + 1, n1 + 1, n2 + 1)
    nodes (default the model's live cells).  G3's plain version."""
    grads, gp_vol = _element_tables(model.spacing)
    lam, mu = (model.lam_cells, model.mu_cells) if cells is None else cells
    nx, ny, nz = lam.shape
    u_l = [xs[..., di:di + nx, dj:dj + ny, dk:dk + nz]
           for (di, dj, dk) in CORNERS]

    # accumulate per-corner force fields across Gauss points
    f = [[None] * 3 for _ in range(8)]
    for gp in range(8):
        g = [[None] * 3 for _ in range(3)]
        for a in range(3):
            for b in range(3):
                acc = None
                for l in range(8):
                    w = float(grads[gp, l, a])
                    if w == 0.0:
                        continue
                    term = u_l[l][b] * float(np.float32(w))
                    acc = term if acc is None else acc + term
                g[a][b] = acc if acc is not None else xs.new_zeros((nx, ny, nz))
        trace = g[0][0] + g[1][1] + g[2][2]
        vol = float(np.float32(gp_vol[gp]))
        stress = [[None] * 3 for _ in range(3)]
        for a in range(3):
            for b in range(a, 3):
                s = mu * (g[a][b] + g[b][a])
                if a == b:
                    s = s + lam * trace
                stress[a][b] = stress[b][a] = s * vol
        for l in range(8):
            for b in range(3):
                acc = f[l][b]
                for a in range(3):
                    w = float(grads[gp, l, a])
                    if w == 0.0:
                        continue
                    term = stress[a][b] * float(np.float32(w))
                    acc = term if acc is None else acc + term
                f[l][b] = acc

    out = torch.zeros_like(xs)
    for l, (di, dj, dk) in enumerate(CORNERS):
        out[:, di : di + nx, dj : dj + ny, dk : dk + nz] += torch.stack(f[l])
    return out


def apply_keff_structured_plain(
    model: StructuredModel, x: torch.Tensor, stiffness_scale, mass_factor
) -> torch.Tensor:
    """K_eff * x, plain PyTorch (the XLA forms of the reference): sanitize ->
    stiffness -> scale -> mass term (the stored ``mass_grid``) -> identity
    rows.  The stiffness is the interior stencil minus the face
    corrections on a homogeneous grid, the corner-gather element loop on a
    heterogeneous one.  Any float dtype, any device.  No absorbing term."""
    xs = x.masked_fill(model.bc_mask, 0.0)
    if model.homogeneous:
        stiff = subtract_face_corrections(
            model, xs, _apply_taps(xs, interior_taps(model))
        )
    else:
        stiff = heterogeneous_stiffness(model, xs)
    return keff_envelope(model, x, xs, stiff, stiffness_scale, mass_factor)


# --------------------------------------------------------------------------
# routing (the reference's ops/structured.py:330-386)
# --------------------------------------------------------------------------

# grids above this node count take the split interior/boundary form where
# the complete-operator kernel is not profitable (the reference's
# flattened-lane and K4 threshold)
_FLAT_INTERIOR_NODE_THRESHOLD = 700_000

# the reference's complete-operator kernel floor (its ADR-23, measured on a
# TPU v5e): enough nodes AND a (Y, Z) plane of enough work per grid step
_KERNEL_MIN_NODES = 500_000
_KERNEL_MIN_PLANE = 5_000  # y*z lanes per plane


def stream_kernel_profitable(model: StructuredModel) -> bool:
    """Whether the reference runs its fused stream kernels (K1/K2/K6) at
    this grid's shape (node count + plane-size floors)."""
    _, y, z = model.grid_shape
    return (
        int(np.prod(model.grid_shape)) > _KERNEL_MIN_NODES
        and y * z >= _KERNEL_MIN_PLANE
    )


def slender_route(model: StructuredModel, dtype) -> bool:
    """Whether the operator of a homogeneous grid takes the split form K4 +
    G2 (a heterogeneous one takes G3 before this is asked): f32 vectors,
    more than ``_FLAT_INTERIOR_NODE_THRESHOLD`` nodes (``grid_shape``, +X
    pad planes included) and a plane too small for the stream kernels (the
    reference's route to ``interior_stencil_pallas``).  Shape alone decides:
    the reference's VMEM plane-fit rule and TPU-backend gate are not
    ported."""
    return (
        dtype == torch.float32
        and int(np.prod(model.grid_shape)) > _FLAT_INTERIOR_NODE_THRESHOLD
        and not stream_kernel_profitable(model)
    )


def apply_keff_split_structured(
    model: StructuredModel, x: torch.Tensor, stiffness_scale, mass_factor
) -> torch.Tensor:
    """K_eff * x in the split form, without the absorbing term: sanitize ->
    K4 interior stencil -> G2 (ghost taps, scale, mass, identity rows)."""
    xs = x.masked_fill(model.bc_mask, 0.0)
    interior = _k4.interior_stencil(xs, interior_taps(model))
    return _g2.keff_boundary(model, interior, x, stiffness_scale, mass_factor)


def apply_keff_structured(
    model: StructuredModel, x: torch.Tensor, stiffness_scale, mass_factor
) -> torch.Tensor:
    """K_eff * x in CSG layout: K1 (or K4 + G2 on :func:`slender_route`)
    on CUDA, the plain forms on CPU; plus the absorbing-face term.  A
    heterogeneous grid takes G3 (the corner gather) on CUDA.  A shard
    takes the sharded operator (ghost exchange + K5) and the terms of the
    faces its block holds."""
    if model.shard_group is not None:
        from .structured_sharded import apply_keff_structured_sharded

        out = apply_keff_structured_sharded(
            model, x, stiffness_scale, mass_factor
        )
    elif not model.homogeneous:
        out = _g3.apply_keff_corner_gather(model, x, stiffness_scale,
                                           mass_factor)
    elif slender_route(model, x.dtype):
        out = apply_keff_split_structured(model, x, stiffness_scale, mass_factor)
    else:
        out = _k12.apply_keff_fused(model, x, stiffness_scale, mass_factor)
    if model.mass_correction is not None and x.device.type == "cuda":
        out = correct_synthesized_mass(model, out, x, mass_factor)
    return add_absorbing_operator_term(model, out, x)


# --------------------------------------------------------------------------
# stored mass against the kernels' synthesized mass (multigrid coarse levels)
# --------------------------------------------------------------------------


class MassCorrection(NamedTuple):
    """The nodes where a model's stored ``mass_grid`` differs from the
    mass the kernels synthesize (``m8`` times 0.5 per boundary axis), as
    flat node indices into (X*Y*Z,) and ``mass_grid - synthesized`` there,
    exact in f64 (both are f32); f32 vectors use it rounded to f32."""

    index: torch.Tensor  # (n,) int64
    delta: torch.Tensor  # (n,) f64


def synthesized_mass(model: StructuredModel) -> torch.Tensor:
    """(X, Y, Z) f32: the lumped mass K1, K2, K6 and G2 use in place of
    ``mass_grid`` — ``m8 * wx * wy * wz`` with w = 0.5 on a boundary class
    and 1 inside, multiplied in the kernels' order."""
    dev = model.device
    w = [
        torch.as_tensor(np.where(axis_classes(n, cells) == 1, 1.0, 0.5),
                        dtype=torch.float32, device=dev)
        for n, cells in zip(model.grid_shape, (model.nx, model.ny, model.nz))
    ]
    m8 = torch.tensor(model.m8, dtype=torch.float32, device=dev)
    return (m8 * w[0])[:, None, None] * w[1][None, :, None] * w[2][None, None, :]


def mass_correction(model: StructuredModel):
    """The :class:`MassCorrection` of an unsharded model, or None where the
    stored mass is the synthesized one bit for bit (every grid that
    ``build_structured_model`` makes).  A multigrid coarse level's mass is P^T m_f: along an axis of
    even fine node count its high-face node carries 0.875 of the interior
    value, not 0.5, so the kernels alone would apply another operator
    there."""
    delta = model.mass_grid.double() - synthesized_mass(model).double()
    delta = delta.reshape(-1)
    index = torch.nonzero(delta).reshape(-1)
    if index.numel() == 0:
        return None
    return MassCorrection(index=index, delta=delta[index].contiguous())


def correct_synthesized_mass(model: StructuredModel, out, x, mass_factor):
    """``out`` (the kernels' K_eff x with synthesized mass) with
    ``mf * (mass_grid - synthesized) * xs`` added on the corrected nodes'
    free components; constrained outputs keep x.  In place, in ``out``'s
    dtype: f32 vectors take delta and mf rounded to f32, f64 ones both in
    f64."""
    corr = model.mass_correction
    flat_out = out.view(3, -1)
    xs = x.reshape(3, -1)[:, corr.index]
    bc = model.bc_mask.reshape(3, -1)[:, corr.index]
    delta = corr.delta.to(out.dtype)
    mf = _cuda_build.scalar(mass_factor, out.dtype)
    add = (delta * mf)[None] * xs.to(out.dtype).masked_fill(bc, 0.0)
    flat_out[:, corr.index] = torch.where(
        bc, flat_out[:, corr.index], flat_out[:, corr.index] + add
    )
    return out


# --------------------------------------------------------------------------
# block-Jacobi preconditioner (CSG layout)
# --------------------------------------------------------------------------


def extended_cells(model: StructuredModel):
    """(lam, mu) of every cell with a corner on the model's node block,
    each (X + 1, Y + 1, nz) f32 for a (X, Y, Z) block: cell (ci, cj) (its
    low corner at block node (ci, cj)) at [ci + 1, cj + 1], ci in [-1, X),
    cj in [-1, Y).  The block's own cells, on a shard the ghost cell
    plane and row (``model.cell_ghosts``), zero for a cell off the global
    grid (x0 + ci outside [0, nx), y0 + cj outside [0, ny)) or with no
    source.  On an unsharded grid: the live cells with a zero frame."""
    X, Y, _ = model.grid_shape
    nz = model.nz
    dev = model.device
    ext = torch.zeros((2, X + 1, Y + 1, nz), dtype=torch.float32, device=dev)
    # the block's cells: a built grid's are padded to the node extent along
    # X, a coarse level's or a class proxy's are the live cells alone
    cols, rows = (min(n, m) for n, m in zip(model.lam_grid.shape, (X, Y)))
    ext[0, 1:cols + 1, 1:rows + 1] = model.lam_grid[:cols, :rows]
    ext[1, 1:cols + 1, 1:rows + 1] = model.mu_grid[:cols, :rows]
    ghosts = model.cell_ghosts
    if ghosts is not None:
        if ghosts.x_lo is not None:
            gy = ghosts.x_lo.shape[1] - model.lam_grid.shape[1]
            ext[:, 0, 1 - gy:1 - gy + ghosts.x_lo.shape[1]] = ghosts.x_lo
        if ghosts.y_lo is not None:
            ext[:, 1:, 0] = ghosts.y_lo
    gx = torch.arange(-1, X, device=dev) + model.x0
    gy_ = torch.arange(-1, Y, device=dev) + model.y0
    live = (((gx >= 0) & (gx < model.nx))[:, None]
            & ((gy_ >= 0) & (gy_ < model.ny))[None, :])
    ext = torch.where(live[None, :, :, None], ext, 0.0)
    return ext[0], ext[1]


def assemble_node_blocks_structured(
    model: StructuredModel, stiffness_scale, mass_factor
) -> torch.Tensor:
    """Per-node 3x3 K_eff diagonal blocks, (3, 3, X, Y, Z) f32.

    Per corner l the gp-summed diagonal block is
    ``scale * [(lam+mu) A_l + mu b_l I]`` with constant
    ``A_l = sum_gp V g_gl (x) g_gl`` and ``b_l = sum_gp V |g_gl|^2``
    (pcg.cpp:270-378 without building Ke), scattered to the 8 corners
    from the block's :func:`extended_cells`: on a shard its edge nodes
    take the ghost cells too, and so get their whole blocks.
    """
    grads, gp_vol = _element_tables(model.spacing)
    a_const = np.einsum("g,gla,glb->lab", gp_vol, grads, grads)  # (8, 3, 3)
    b_const = np.einsum("g,gla,gla->l", gp_vol, grads, grads)  # (8,)
    X, Y, _ = model.grid_shape
    nz = model.nz

    ss = float(np.float32(stiffness_scale))
    lam, mu = extended_cells(model)
    lam_mu = (lam + mu) * ss
    mu = mu * ss
    mf = float(np.float32(mass_factor))

    rows = []
    for a in range(3):
        for b in range(3):
            acc = torch.zeros(
                model.grid_shape, dtype=torch.float32, device=model.device
            )
            for l, (di, dj, dk) in enumerate(CORNERS):
                contrib = lam_mu * float(np.float32(a_const[l, a, b]))
                if a == b:
                    contrib = contrib + mu * float(np.float32(b_const[l]))
                acc[:, :, dk : dk + nz] += contrib[
                    1 - di : 1 - di + X, 1 - dj : 1 - dj + Y
                ]
            if a == b:
                acc = acc + model.mass_grid * mf
            rows.append(acc)
    return torch.stack(rows).reshape(3, 3, *model.grid_shape)


def _det3_lead(m: torch.Tensor) -> torch.Tensor:
    return (
        m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
        - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
        + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0])
    )


def _adjugate_lead(m: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1],
            m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2],
            m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1],
            m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2],
            m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0],
            m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2],
            m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0],
            m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1],
            m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0],
        ]
    ).reshape(3, 3, *m.shape[2:])


def _invert_spd_3x3_lead(blocks: torch.Tensor) -> torch.Tensor:
    """Regularized SPD 3x3 inverse on leading axes (pcg.cpp:215-268)."""
    det = _det3_lead(blocks)
    singular = det.abs() < _DET_TOL

    diag = torch.stack([blocks[0, 0], blocks[1, 1], blocks[2, 2]])
    max_diag = diag.max(dim=0).values
    epsilon = torch.clamp_min(max_diag * 1.0e-6 + 1.0e-12, 1.0e-6)
    eye = torch.eye(3, dtype=blocks.dtype, device=blocks.device).reshape(
        3, 3, *([1] * (blocks.ndim - 2))
    )
    regularized = torch.where(
        singular[None, None], blocks + epsilon[None, None] * eye, blocks
    )
    det2 = _det3_lead(regularized)
    still_singular = det2.abs() < _DET_TOL

    inv_det = 1.0 / torch.where(still_singular, 1.0, det2)
    inverse = _adjugate_lead(regularized) * inv_det[None, None]

    reg_diag = torch.stack(
        [regularized[0, 0], regularized[1, 1], regularized[2, 2]]
    )
    inv_diag = 1.0 / torch.clamp_min(reg_diag, 1.0e-6)
    diag_only = inv_diag[:, None] * eye
    return torch.where(still_singular[None, None], diag_only, inverse)


def build_block_jacobi_inverse_structured(
    model: StructuredModel, stiffness_scale, mass_factor
) -> torch.Tensor:
    """Symmetric-packed inverse blocks (6, X, Y, Z): [00, 11, 22, 01, 02, 12]
    (pcg.cpp:479-503).  Constrained rows and columns are unreachable: PCG
    clamps r to 0 there and the apply writes +0.0 on constrained outputs."""
    blocks = assemble_node_blocks_structured(model, stiffness_scale, mass_factor)
    inverse = _invert_spd_3x3_lead(blocks)
    return torch.stack(
        [
            inverse[0, 0],
            inverse[1, 1],
            inverse[2, 2],
            inverse[0, 1],
            inverse[0, 2],
            inverse[1, 2],
        ]
    )


def apply_preconditioner_structured(
    model: StructuredModel, block_inverse: torch.Tensor, residual: torch.Tensor
) -> torch.Tensor:
    """z = M^-1 r from the per-node symmetric-packed inverse
    ``block_inverse`` (6, X, Y, Z), constrained outputs +0.0 by select
    (pcg.cpp:410-456).  The reference computes it in XLA with no Pallas
    kernel; these torch ops are its counterpart on every device."""
    c00, c11, c22, c01, c02, c12 = block_inverse
    r0, r1, r2 = residual
    z = torch.stack(
        [
            c00 * r0 + c01 * r1 + c02 * r2,
            c01 * r0 + c11 * r1 + c12 * r2,
            c02 * r0 + c12 * r1 + c22 * r2,
        ]
    )
    return z.masked_fill(model.bc_mask, 0.0)


class CompactBlockJacobi(NamedTuple):
    """Class-table block-Jacobi inverse for homogeneous uniform grids.

    The assembled 3x3 node block depends only on the node's per-axis
    boundary class (low face / interior / high face), so the per-node
    (6, X, Y, Z) packed inverse carries exactly the (6, 3, 3, 3) table

        inv[m, i, j, k] = table[m, x_class(i), y_class(j), z_class(k)].
    """

    table: torch.Tensor  # (6, 3, 3, 3) f32 — [comp, x-class, y-class, z-class]


def _class_proxy(model: StructuredModel) -> StructuredModel:
    """An unsharded grid of min(n, 2) cells per axis with the model's
    spacing, material and interior mass: it has every boundary class of
    the model (none but the interior one depends on n), and each class's
    block is assembled from the same corner terms in the same order, so the
    class table it yields is the model's bit for bit."""
    import dataclasses

    cells = tuple(min(n, 2) for n in (model.nx, model.ny, model.nz))
    dev = model.device
    weights = [
        torch.as_tensor(np.where(axis_classes(n + 1, n) == 1, 1.0, 0.5),
                        dtype=torch.float32, device=dev)
        for n in cells
    ]
    mass = (float(np.float32(model.m8)) * weights[0][:, None, None]
            * weights[1][None, :, None] * weights[2][None, None, :])
    nodes = tuple(n + 1 for n in cells)
    return dataclasses.replace(
        model,
        lam_grid=torch.full(cells, model.lam0, dtype=torch.float32, device=dev),
        mu_grid=torch.full(cells, model.mu0, dtype=torch.float32, device=dev),
        mass_grid=mass,
        bc_mask=torch.zeros((3, *nodes), dtype=torch.bool, device=dev),
        bc_value=torch.zeros((3, *nodes), dtype=torch.float32, device=dev),
        nx=cells[0], ny=cells[1], nz=cells[2],
        pad_planes=0, pad_rows=0, shard_group=None, x0=0, y0=0,
        local_extent=None, bc_ghosts=None, cell_ghosts=None,
    )


def build_compact_block_jacobi(
    model: StructuredModel, stiffness_scale, mass_factor
) -> CompactBlockJacobi:
    """Compact form of :func:`build_block_jacobi_inverse_structured`: the
    full per-node inverse (built only when dt changes — the stepper hoists
    it) sliced at one representative node per class combination.
    Degenerate extents (n == 1: no interior class) leave the interior
    entry unused.  A shard builds the table from :func:`_class_proxy` (its
    own fields are local)."""
    if model.shard_group is not None:
        model = _class_proxy(model)
    full = build_block_jacobi_inverse_structured(
        model, stiffness_scale, mass_factor
    )
    xsel = [0, min(1, model.nx), model.nx]
    ysel = [0, min(1, model.ny), model.ny]
    zsel = [0, min(1, model.nz), model.nz]
    table = full[:, xsel][:, :, ysel][:, :, :, zsel]  # (6, 3, 3, 3)
    return CompactBlockJacobi(table=table.contiguous())


def apply_compact_preconditioner_structured_plain(
    model: StructuredModel, table: torch.Tensor, residual: torch.Tensor
) -> torch.Tensor:
    """z = M^-1 r from the class table, plain PyTorch (the reference's XLA
    form): the coefficient grids are broadcast products of a per-x-plane
    table gather with one-hot y/z class vectors.  Constrained outputs are
    +0.0 by select.  A shard's nodes take their classes at their global
    coordinates (offsets ``x0``/``y0``)."""
    x_planes, ys, zs = model.grid_shape
    dev = residual.device
    clsx = torch.as_tensor(axis_classes(x_planes, model.nx, model.x0), device=dev)
    tab_x = table[:, clsx]  # (6, X, 3, 3)
    eye = np.eye(3, dtype=np.float32)
    wy = eye[:, axis_classes(ys, model.ny, model.y0)]  # (3, Y)
    wz = eye[:, axis_classes(zs, model.nz)]  # (3, Z)

    def coef(m):  # (X, Y, Z) coefficient map
        t = tab_x[m]  # (X, 3, 3)
        c = None
        for a in range(3):
            for b in range(3):
                yz = torch.as_tensor(wy[a][:, None] * wz[b][None, :], device=dev)
                term = t[:, a, b][:, None, None] * yz[None]
                c = term if c is None else c + term
        return c

    c00, c11, c22, c01, c02, c12 = (coef(m) for m in range(6))
    r0, r1, r2 = residual
    z = torch.stack(
        [
            c00 * r0 + c01 * r1 + c02 * r2,
            c01 * r0 + c11 * r1 + c12 * r2,
            c02 * r0 + c12 * r1 + c22 * r2,
        ]
    )
    return z.masked_fill(model.bc_mask, 0.0)


def apply_compact_preconditioner_structured(
    model: StructuredModel, pc: CompactBlockJacobi, residual: torch.Tensor
) -> torch.Tensor:
    """z = M^-1 r from the class table: the K3 kernel on CUDA, the plain
    form on CPU."""
    return _k3.apply_block_jacobi(model, pc.table, residual)


def pc_keff_kernel_eligible(model: StructuredModel, pc, dtype) -> bool:
    """The structured route's fused kernels, K2 and (behind its switch) K6,
    serve the iteration: an unsharded grid, the class-table preconditioner
    (which a V-cycle or a heterogeneous grid's per-node inverse is not),
    f32 vectors (the kernels are f32 only, as the reference's) and not the
    slender route (where the reference's stream kernels are not
    profitable).  The device does not enter: CPU tensors run the kernels'
    plain forms."""
    return (
        model.shard_group is None
        and model.homogeneous
        and isinstance(pc, CompactBlockJacobi)
        and dtype == torch.float32
        and not slender_route(model, dtype)
    )


def apply_pc_keff_structured(
    model: StructuredModel, pc, residual: torch.Tensor, stiffness_scale,
    mass_factor,
):
    """(u, w) = (M^-1 r, K_eff u) — the back-to-back pc apply + matvec of
    the Chronopoulos-Gear iteration: one K2 launch on CUDA (the
    composition of the two plain forms on CPU) plus the absorbing term on
    w; off :func:`pc_keff_kernel_eligible` the model's preconditioner
    (the V-cycle under multigrid) and operator composed."""
    if not pc_keff_kernel_eligible(model, pc, residual.dtype):
        u = model.apply_preconditioner(pc, residual)
        return u, model.apply_keff(u, stiffness_scale, mass_factor)
    u, w = _k12.apply_pc_keff_fused(
        model, pc.table, residual, stiffness_scale, mass_factor
    )
    return u, add_absorbing_operator_term(model, w, u)


def apply_pc_keff_dots_structured(
    model: StructuredModel, pc, residual: torch.Tensor,
    stiffness_scale, mass_factor, reduction_dtype=torch.float64,
):
    """(u, w, (gamma, delta, rr)) with the three Chronopoulos-Gear dots
    (r,u), (w,u), (r,r) reduced in ``reduction_dtype``: on CUDA emitted as
    row partials by the same K2 pass; on CPU the plain K2 followed by
    :func:`~civiwave_tpu_torch.solver.pcg.fused_dots`.

    None — the caller composes ``apply_pc_keff`` and ``fused_dots`` — off
    :func:`pc_keff_kernel_eligible` and with absorbing faces: the face term
    is added to w after the kernel, so an in-kernel (w, u) partial would
    miss it."""
    if model.absorb_faces or not pc_keff_kernel_eligible(
            model, pc, residual.dtype):
        return None
    return _k12.apply_pc_keff_fused(
        model, pc.table, residual, stiffness_scale, mass_factor,
        with_dots=True, reduction_dtype=reduction_dtype,
    )


def build_fused_pcg_iteration(
    model: StructuredModel, pc, stiffness_scale, mass_factor,
    reduction_dtype=torch.float64, vector_dtype=torch.float32,
):
    """Whole-iteration PCG bundle, or None when ineligible.

    Returns ``iteration(carries, alpha, beta)``, which runs ONE
    Chronopoulos-Gear iteration on the carries ``(x, r, u, w, p, s)`` (the
    p/s recurrence, the x/r axpys, the class-table preconditioner, K_eff
    and all three dots) and returns the updated carries and ``(gamma,
    delta, rr)`` in ``reduction_dtype``: one K6 launch on CUDA (which
    updates x, u and p in place), the plain K6 on CPU.  The carries are
    the plain solver vectors; the reference's x_ext padding is not ported,
    so there is no pad/unpad step.

    Opt-in through ``CIVIWAVE_MEGA_PCG=1``, read at call time, as in the
    reference (its ADR-22: on v5e the whole-iteration kernel lost to the
    split form).  Eligibility is :func:`pc_keff_kernel_eligible` (the
    reference's rules minus its TPU-only ones: VMEM plane fit, even plane
    count, TPU backend) and no absorbing faces (the kernel could not add
    the face term to w).
    """
    if (os.environ.get("CIVIWAVE_MEGA_PCG", "0") != "1" or model.absorb_faces
            or not pc_keff_kernel_eligible(model, pc, vector_dtype)):
        return None

    def iteration(carries, alpha, beta):
        return _k6.pcg_iteration_fused(
            model, pc.table, carries, alpha, beta, stiffness_scale,
            mass_factor, reduction_dtype,
        )

    return iteration


# --------------------------------------------------------------------------
# Lysmer-Kuhlemeyer absorbing faces (the reference's ops/structured.py:
# 1004-1076)
# --------------------------------------------------------------------------

_FACE_TAGS = {"x0": (0, 0), "x1": (0, 1), "y0": (1, 0), "y1": (1, 1),
              "z0": (2, 0), "z1": (2, 1)}


@lru_cache(maxsize=64)
def _face_weights(tag, spacing, extents, offsets, local_shape, rho_cp,
                  rho_cs, device):
    """(plane index, (3, 1, 1) impedances, (d1, d2) tributary areas) of
    one absorbing face on a block of ``local_shape`` nodes at node
    ``offsets`` of the grid (a shard's; zeros unsharded), f32 on
    ``device``, uploaded once; None where the block does not hold the
    face's plane.  Plane and edges lie at global coordinates: only the end
    slabs (and in 2-D the edge tiles) hold x/y faces, an X-padded grid's
    x1 plane need not lie in the last slab, and the halved tributary areas
    fall on the grid's edges, not a block's."""
    axis, side = _FACE_TAGS[tag]
    plane = (0 if side == 0 else extents[axis]) - offsets[axis]
    if not 0 <= plane < local_shape[axis]:
        return None
    in_plane = [a for a in range(3) if a != axis]
    area = float(spacing[in_plane[0]] * spacing[in_plane[1]])
    sl = [slice(None)] * 4
    sl[1 + axis] = plane
    half, one = np.float32(0.5), np.float32(1.0)
    r1, r2 = (offsets[a] + np.arange(local_shape[a]) for a in in_plane)
    w1 = np.where((r1 == 0) | (r1 == extents[in_plane[0]]), half, one)
    w2 = np.where((r2 == 0) | (r2 == extents[in_plane[1]]), half, one)
    aw = np.float32(area) * (w1[:, None] * w2[None, :])
    coef = np.array([rho_cs, rho_cs, rho_cs], np.float32)
    coef[axis] = np.float32(rho_cp)
    return (
        tuple(sl),
        torch.as_tensor(coef, device=device)[:, None, None],
        torch.as_tensor(aw, device=device),
    )


def _face_damp_terms(model: StructuredModel, x: torch.Tensor):
    """Yield (plane index, masked C x term) per absorbing face the model's
    block holds (every face on an unsharded model).

    Per node on face (axis, side) C is diagonal in the grid frame: rho*c_p
    against the normal component, rho*c_s tangential, times the tributary
    face area (the in-plane spacing product, halved at plane edges as the
    lumped mass).  Output components on constrained axes are zeroed and
    the input plane is sanitized, so the term is P_free C P_free:
    symmetric, as CG requires."""
    extents = (model.nx, model.ny, model.nz)
    offsets = (model.x0, model.y0, 0)
    for tag in model.absorb_faces:
        face = _face_weights(
            tag, model.spacing, extents, offsets, model.grid_shape,
            model.rho_cp, model.rho_cs, x.device,
        )
        if face is None:
            continue
        sl, coef, aw = face
        bc_plane = model.bc_mask[sl]
        xs_plane = x[sl].masked_fill(bc_plane, 0.0)
        yield sl, (coef * (aw[None] * xs_plane)).masked_fill(bc_plane, 0.0)


def add_absorbing_operator_term(
    model: StructuredModel, out: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """out += damp_factor * C x on the absorbing face planes, in place (a
    no-op without absorbing faces or before the stepper set the Newmark a1
    factor).  Applied after the identity rows: the term is bc-masked, so
    constrained entries stay the passthrough."""
    if not model.absorb_faces or model.damp_factor is None:
        return out
    factor = _cuda_build.scalar(model.damp_factor, out.dtype)
    for sl, term in _face_damp_terms(model, x):
        out[sl] += factor * term.to(out.dtype)
    return out


def absorbing_force_structured(
    model: StructuredModel, v: torch.Tensor
) -> torch.Tensor:
    """C v (no a1 factor): the Newmark right-hand side's damping force."""
    out = torch.zeros_like(v)
    for sl, term in _face_damp_terms(model, v):
        out[sl] += term.to(out.dtype)
    return out
