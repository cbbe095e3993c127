"""Wrapper of the heterogeneous structured operator kernel G3, with the
host tables of its split element matrix.

G3, ``corner_gather`` (``csrc/corner_gather.cu``), is a kernel the port
needs where the reference uses XLA: the complete ``bc ? x : ss *
K(lam_c, mu_c) xs + mf * mass * xs`` of a heterogeneous structured grid
(per-cell ``lam_grid``/``mu_grid``), the reference's
``_apply_heterogeneous_stiffness`` and the envelope around it
(civiwave_tpu/ops/structured.py:503-552, :603-609).  It is K1's plane
sweep with two stages inside the block: each cell of the tile multiplies
its 24 sanitized corner values by the packed 48 x 24 table [A; B] of the
split element matrix ``lam_c A + mu_c B`` (f32: FFMA, the table in the
launch's parameter bank; f64: the tensor cores' m8n8k4 DMMA, the table in
fragment order, :func:`kernel_tables`), then each node gathers the corner
forces of its <= 8 cells from shared memory.  The geometry is
``plane_sweep.corner_gather_geometry``.  The mass is the stored
``mass_grid``.

On a shard (``parallel.sharding.shard_structured``) G3 runs over a range
of the block's X planes, as K5 does for a homogeneous shard: the
neighbours beyond the block come from the exchanged ghosts of x (an
``ops.structured_sharded.Ghosts``) and of the mask (``model.bc_ghosts``),
and the cells below it from the ghost cell plane and row of λ and μ
(``model.cell_ghosts``, exchanged once at shard time).  A cell is live at
its global coordinate.  Every cut, gathered, equals the whole grid bit for
bit.

A CPU tensor takes the plain version: on a whole grid
``ops.structured.apply_keff_structured_plain`` (the reference's
corner-gather element loop in torch ops on a heterogeneous grid), on a
shard or a plane range :func:`apply_keff_corner_gather_plain_shard`; a
CUDA tensor launches the kernel or raises (f32 or f64 vectors,
contiguous, the model's shapes).  An f64 vector launches the f64
instance, with ss and mf in f64 and the tables in f64.
``apply_keff_corner_gather.launches`` counts the f32 launches and
``.launches_f64`` the f64 ones.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _build, plane_sweep
from .keff_halo import _ghost_y, _planes


@lru_cache(maxsize=16)
def _pair_tables(spacing, f64: bool) -> np.ndarray:
    from ..structured import _element_tables

    grads, gp_vol = _element_tables(spacing)
    w = grads.astype(np.float32).astype(np.float64)  # (8 gp, 8 l, 3)
    v = gp_vol.astype(np.float32).astype(np.float64)  # (8 gp,)
    a = np.einsum("g,glb,gmc->lbmc", v, w, w)
    b = np.einsum("g,glc,gmb->lbmc", v, w, w)
    dot = np.einsum("g,gla,gma->lm", v, w, w)
    for c in range(3):
        b[:, c, :, c] += dot
    table = np.stack([a, b])
    table = np.ascontiguousarray(table if f64 else table.astype(np.float32))
    table.setflags(write=False)
    return table


def pair_tables(spacing, dtype) -> np.ndarray:
    """(2, 8, 3, 8, 3) host tables [A, B][l][b][m][c] of the split element
    matrix K_e = lam A + mu B in the vector dtype: A[l,b,m,c] = sum_gp V
    g[gp,l,b] g[gp,m,c], B[l,b,m,c] = sum_gp V (delta_bc g[gp,l,:].g[gp,m,:]
    + g[gp,l,c] g[gp,m,b]) over the f32-rounded Gauss gradients and volumes
    the plain version multiplies, summed in f64 (then rounded to f32 for
    f32 vectors)."""
    return _pair_tables(tuple(float(h) for h in spacing),
                        dtype == torch.float64)


def packed_tables(spacing, dtype) -> np.ndarray:
    """(48, 24) [A; B] as G3 multiplies it: row (A/B) * 24 + b * 8 + l
    (output component b of corner l), column c * 8 + m (component c of
    corner m), so that a cell's 24 corner values u[c * 8 + m] give its
    corner forces f[b * 8 + l] = lam (A u) + mu (B u) from rows r and
    24 + r.  The values of :func:`pair_tables`, in its dtype."""
    table = pair_tables(spacing, dtype)  # [A/B][l][b][m][c]
    return np.ascontiguousarray(table.transpose(0, 2, 1, 4, 3).reshape(48, 24))


def dmma_fragments(packed: np.ndarray) -> np.ndarray:
    """(6, 6, 32) ``packed`` in the A-fragment order of mma.sync m8n8k4
    (row-major A, 8 x 4 per tile): [mt][ks][lane] = packed[8 mt + lane //
    4, 4 ks + lane % 4], row tile mt, k step ks, the value lane ``lane``
    holds."""
    lane = np.arange(32)
    rows = 8 * np.arange(6)[:, None, None] + lane // 4
    cols = 4 * np.arange(6)[None, :, None] + lane % 4
    return np.ascontiguousarray(packed[rows, cols])


@lru_cache(maxsize=16)
def _kernel_tables(spacing, f64: bool) -> np.ndarray:
    packed = packed_tables(spacing, torch.float64 if f64 else torch.float32)
    table = dmma_fragments(packed) if f64 else packed
    table.setflags(write=False)
    return table


def kernel_tables(spacing, dtype) -> np.ndarray:
    """The 1,152 table values G3's instance for ``dtype`` takes by value:
    :func:`packed_tables` row-major in f32 (FFMA at compile-time indices),
    its :func:`dmma_fragments` in f64."""
    return _kernel_tables(tuple(float(h) for h in spacing),
                          dtype == torch.float64)


def _xy_framed(block, ghosts, gy: int):
    """The node block (3, Xl, Yl, Z) with a one-node frame in X and Y: the
    X ghost planes (Y-extended in 2-D) and in 2-D the Y ghost rows, zero
    elsewhere (missing ghosts; along Y in 1-D).  Z is not framed: the
    cells span it."""
    _, xl, yl, z = block.shape
    full = block.new_zeros((3, xl + 2, yl + 2, z))
    full[:, 1:-1, 1:-1] = block
    if ghosts is None:
        return full
    rows = slice(None) if gy else slice(1, -1)  # the X planes' Y extent
    for plane, g in ((0, ghosts.x_lo), (xl + 1, ghosts.x_hi)):
        if g is not None:
            full[:, plane, rows] = g
    if gy:
        for row, g in ((0, ghosts.y_lo), (yl + 1, ghosts.y_hi)):
            if g is not None:
                full[:, 1:-1, row] = g
    return full


def apply_keff_corner_gather_plain_shard(
    model, x, stiffness_scale, mass_factor, ghosts=None, planes=None, out=None
):
    """Plain PyTorch G3 on a shard: the ghost-padded x block and its
    mask, sanitized, through ``ops.structured.heterogeneous_stiffness``
    over the block's extended cells (``ops.structured.extended_cells``:
    its own, the ghost cell plane and row, zero off the global grid), term
    by term as on a whole grid, then the envelope, on planes ``[p0, p1)``
    of ``out`` (new if None).  Gathered over a cut, it equals the plain
    version of the whole grid bit for bit."""
    from ..structured import extended_cells, heterogeneous_stiffness

    p0, p1 = _planes(model, planes)
    gy = _ghost_y(model)
    xs = _xy_framed(x, ghosts, gy).masked_fill(
        _xy_framed(model.bc_mask, model.bc_ghosts, gy), 0.0
    )[:, p0:p1 + 2]
    lam, mu = extended_cells(model)
    stiff = heterogeneous_stiffness(
        model, xs, (lam[p0:p1 + 1], mu[p0:p1 + 1])
    )[:, 1:-1, 1:-1]
    # ops.structured.keff_envelope's arithmetic on the planes
    own = xs[:, 1:-1, 1:-1]
    res = stiff * float(stiffness_scale)
    res = res + (model.mass_grid[p0:p1].to(x.dtype)
                 * float(mass_factor))[None] * own
    if out is None:
        out = torch.empty_like(x)
    out[:, p0:p1] = torch.where(model.bc_mask[:, p0:p1], x[:, p0:p1], res)
    return out


def _cell_ghost_ptrs(model, xl: int, yl_cells: int, nz: int, gy: int, dev):
    """lam_gx, mu_gx, lam_gy, mu_gy of the model's cell ghosts (None: none)."""
    g = model.cell_ghosts
    ptrs = []
    for side, shape in (("x_lo", (2, yl_cells + gy, nz)), ("y_lo", (2, xl, nz))):
        t = None if g is None else getattr(g, side)
        if t is not None:
            _build.check_tensor(t, f"cell ghost {side}", shape, torch.float32,
                                dev)
        ptrs += [None, None] if t is None else [t[0].data_ptr(),
                                                t[1].data_ptr()]
    return ptrs


def apply_keff_corner_gather(model, x, stiffness_scale, mass_factor,
                             ghosts=None, planes=None, out=None):
    """G3: planes ``[p0, p1)`` (default all) of K_eff * x through the
    model's per-cell lam_grid/mu_grid (the operator of a heterogeneous
    grid, or of a shard of one with its x ``ghosts``, an
    ``ops.structured_sharded.Ghosts``) into ``out`` (new if None), which is
    returned; kernel on CUDA (its f64 instance for f64 vectors), plain
    version on CPU."""
    shard = model.local_extent is not None
    if x.device.type == "cpu":
        if not shard and ghosts is None and planes is None and out is None:
            from ..structured import apply_keff_structured_plain

            return apply_keff_structured_plain(
                model, x, stiffness_scale, mass_factor
            )
        return apply_keff_corner_gather_plain_shard(
            model, x, stiffness_scale, mass_factor, ghosts, planes, out
        )
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    dtype = x.dtype
    entry = _build.instance("civi_corner_gather", dtype)
    X, Y, Z = model.grid_shape
    shape = model.vector_shape
    cell_y = model.lam_grid.shape[1]
    cells = (X, cell_y, model.nz)
    _build.check_tensor(x, "vector", shape, dtype, dev)
    _build.check_tensor(model.bc_mask, "bc_mask", shape, torch.bool, dev)
    _build.check_tensor(model.lam_grid, "lam_grid", cells, torch.float32, dev)
    _build.check_tensor(model.mu_grid, "mu_grid", cells, torch.float32, dev)
    _build.check_tensor(model.mass_grid, "mass_grid", shape[1:], torch.float32,
                        dev)
    _build.check_aligned(model.bc_mask, "bc_mask", 4)
    gx_n, gy_n, _ = model.global_grid_shape
    if not (model.nz == Z - 1 and cell_y <= Y and model.x0 + X <= gx_n
            and model.y0 + Y <= gy_n and (shard or model.ny <= cell_y)):
        raise ValueError(
            f"cells ({model.nx}, {model.ny}, {model.nz}) in {cell_y} rows "
            f"against the block {shape[1:]} at ({model.x0}, {model.y0}) of "
            f"the grid {model.global_grid_shape}")
    gy = _ghost_y(model)
    ptrs = []  # x's ghosts and the mask's, side by side; None reads as zero
    for side in ("x_lo", "x_hi", "y_lo", "y_hi"):
        gshape = (3, Y + 2 * gy, Z) if side[0] == "x" else (3, X, Z)
        for g, gtype in ((getattr(ghosts, side, None), dtype),
                         (getattr(model.bc_ghosts, side, None), torch.bool)):
            if g is not None and (side[0] == "x" or gy):
                _build.check_tensor(g, f"ghost {side}", gshape, gtype, dev)
                if gtype == torch.bool:
                    _build.check_aligned(g, f"ghost {side} mask", 4)
                ptrs.append(g.data_ptr())
            else:
                ptrs.append(None)
    p0, p1 = _planes(model, planes)
    geom = plane_sweep.corner_gather_geometry(model.grid_shape,
                                              x.element_size(), (p0, p1))
    tables = kernel_tables(model.spacing, dtype)
    if out is None:
        out = torch.empty_like(x)
    _build.check_tensor(out, "out", shape, dtype, dev)
    library = _build.load_library()
    with torch.cuda.device(dev):
        code = getattr(library.lib, entry)(
            x.data_ptr(), model.bc_mask.data_ptr(), *ptrs,
            model.lam_grid.data_ptr(), model.mu_grid.data_ptr(),
            *_cell_ghost_ptrs(model, X, cell_y, model.nz, gy, dev),
            model.mass_grid.data_ptr(), tables.ctypes.data, out.data_ptr(),
            X, Y, Z, gy, model.x0, model.y0, model.nx, model.ny, model.nz,
            cell_y, p0, p1, _build.scalar(stiffness_scale, dtype),
            _build.scalar(mass_factor, dtype), *geom.launch_args()[:6],
            geom.threads, geom.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(library, "corner_gather", code)
    _build.count_launch(apply_keff_corner_gather, dtype)
    return out


apply_keff_corner_gather.launches = 0
apply_keff_corner_gather.launches_f64 = 0
