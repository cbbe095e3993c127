"""Wrapper of the heterogeneous structured operator kernel G3, with the
host tables of its split element matrix.

G3, ``corner_gather`` (``csrc/corner_gather.cu``), is a kernel the port
needs where the reference uses XLA: the complete ``bc ? x : ss *
K(lam_c, mu_c) xs + mf * mass * xs`` of a heterogeneous structured grid
(per-cell ``lam_grid``/``mu_grid``), the reference's
``_apply_heterogeneous_stiffness`` and the envelope around it
(civiwave_tpu/ops/structured.py:503-552, :603-609).  One thread per node
gathers its <= 8 incident cells, each through the split element matrix
``lam_c A + mu_c B``; A and B (:func:`pair_tables`) travel by value as a
kernel argument.  The mass is the stored ``mass_grid``.

A CPU tensor takes the plain version,
``ops.structured.apply_keff_structured_plain`` (the reference's
corner-gather element loop in torch ops on a heterogeneous grid); a CUDA
tensor launches the kernel or raises (f32 or f64 vectors, contiguous, the
model's shapes).  An f64 vector launches the f64 instance, with ss and mf
in f64 and the tables in f64.
``apply_keff_corner_gather.launches`` counts the f32 launches and
``.launches_f64`` the f64 ones.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _build


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
    return np.ascontiguousarray(table if f64 else table.astype(np.float32))


def pair_tables(spacing, dtype) -> np.ndarray:
    """(2, 8, 3, 8, 3) host tables [A, B][l][b][m][c] of the split element
    matrix K_e = lam A + mu B in the vector dtype: A[l,b,m,c] = sum_gp V
    g[gp,l,b] g[gp,m,c], B[l,b,m,c] = sum_gp V (delta_bc g[gp,l,:].g[gp,m,:]
    + g[gp,l,c] g[gp,m,b]) over the f32-rounded Gauss gradients and volumes
    the plain version multiplies, summed in f64 (then rounded to f32 for
    f32 vectors)."""
    return _pair_tables(tuple(float(h) for h in spacing),
                        dtype == torch.float64)


def apply_keff_corner_gather(model, x, stiffness_scale, mass_factor):
    """G3: K_eff * x through the model's per-cell lam_grid/mu_grid (the
    operator of a heterogeneous grid); kernel on CUDA (its f64 instance for
    f64 vectors), plain version on CPU."""
    if x.device.type == "cpu":
        from ..structured import apply_keff_structured_plain

        return apply_keff_structured_plain(
            model, x, stiffness_scale, mass_factor
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
    if not (model.nx < X and model.ny <= cell_y):
        raise ValueError(f"cells ({model.nx}, {model.ny}) outside {cells}")
    tables = pair_tables(model.spacing, dtype)
    out = torch.empty_like(x)
    library = _build.load_library()
    with torch.cuda.device(dev):
        code = getattr(library.lib, entry)(
            x.data_ptr(), model.bc_mask.data_ptr(), model.lam_grid.data_ptr(),
            model.mu_grid.data_ptr(), model.mass_grid.data_ptr(),
            tables.ctypes.data, out.data_ptr(), X, Y, Z, model.nx, model.ny,
            model.nz, cell_y, _build.scalar(stiffness_scale, dtype),
            _build.scalar(mass_factor, dtype),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(library, "corner_gather", code)
    _build.count_launch(apply_keff_corner_gather, dtype)
    return out


apply_keff_corner_gather.launches = 0
apply_keff_corner_gather.launches_f64 = 0
