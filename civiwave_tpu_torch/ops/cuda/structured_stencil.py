"""Wrappers of the structured-operator kernels K1 and K2, with their plain
versions.

K1, ``keff_structured``, replaces the Pallas kernel
``apply_keff_fused_pallas`` (civiwave_tpu/ops/pallas/
structured_stencil.py:931, pallas_call at :1041/:1068): the complete
``bc ? x : ss * K(xs) + mf * mass * xs`` in one pass.  It launches the
shard operator kernel of ``csrc/keff_structured_halo.cu`` (K5,
``keff_halo.py``), a plane sweep, on the whole grid with no ghosts, as the
reference's sharded forms call the same Pallas function.

K2, ``pc_keff_structured`` (``csrc/pc_keff_structured.cu``), replaces
``apply_pc_keff_fused_pallas`` (structured_stencil.py:820, pallas_call at
:895): ``u = M^-1 r`` from the (6, 3, 3, 3) class table and ``w = K_eff u``
in one launch, a plane sweep whose geometry ``plane_sweep.py`` computes,
plus with ``with_dots`` each block's f32 partials of (r, u), (r, r) and
(w, u), summed here in the reduction dtype.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises (contiguous, shapes of the model; K2 f32 only, as the reference's
kernel; K1 f32 or f64, the f64 vectors on K5's f64 instance).  Each wrapper
counts its launches in ``<wrapper>.launches``, a plain int that only a
launch increments (K1's f64 launches in ``.launches_f64``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, keff_halo, plane_sweep
from .plane_sweep import sweep_taps32


def _launch_args(model, residual_or_x):
    """Common shape/device checks; returns (library, device)."""
    dev = residual_or_x.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _build.check_homogeneous(model, "pc_keff_structured")
    shape = model.vector_shape
    _build.check_tensor(residual_or_x, "vector", shape, torch.float32, dev)
    _build.check_tensor(model.bc_mask, "bc_mask", shape, torch.bool, dev)
    _build.check_tensor(
        model.stencil_table, "stencil_table", (27, 27, 3, 3), torch.float32,
        dev,
    )
    return _build.load_library(), dev


def apply_keff_fused_plain(model, x, stiffness_scale, mass_factor):
    """Plain PyTorch K_eff * x (the reference's XLA form: interior stencil
    minus inclusion-exclusion corrections, envelope by select)."""
    from ..structured import apply_keff_structured_plain

    return apply_keff_structured_plain(model, x, stiffness_scale, mass_factor)


def apply_keff_fused(model, x, stiffness_scale, mass_factor):
    """K1: the complete K_eff * x; kernel on CUDA (its f64 instance for f64
    vectors), plain version on CPU."""
    if x.device.type == "cpu":
        return apply_keff_fused_plain(model, x, stiffness_scale, mass_factor)
    out = keff_halo.launch_operator(model, x, None, None, None,
                                    stiffness_scale, mass_factor,
                                    "keff_structured")
    _build.count_launch(apply_keff_fused, x.dtype)
    return out


apply_keff_fused.launches = 0
apply_keff_fused.launches_f64 = 0


def apply_pc_keff_fused_plain(
    model, table, residual, stiffness_scale, mass_factor, *,
    with_dots: bool = False, reduction_dtype=torch.float64,
):
    """Plain PyTorch (u, w[, dots]): the class-table apply, then the plain
    operator, then the three dots via fused_dots."""
    from ...solver.pcg import fused_dots
    from ..structured import (
        apply_compact_preconditioner_structured_plain,
        apply_keff_structured_plain,
    )

    u = apply_compact_preconditioner_structured_plain(model, table, residual)
    w = apply_keff_structured_plain(model, u, stiffness_scale, mass_factor)
    if not with_dots:
        return u, w
    gamma, delta, rr = fused_dots(
        [(residual, u), (w, u), (residual, residual)], reduction_dtype
    )
    return u, w, (gamma, delta, rr)


def apply_pc_keff_fused(
    model, table, residual, stiffness_scale, mass_factor, *,
    with_dots: bool = False, reduction_dtype=torch.float64,
):
    """K2: ``(u, w)`` or ``(u, w, (gamma, delta, rr))`` with gamma = (r,u),
    delta = (w,u), rr = (r,r) in ``reduction_dtype``; kernel on CUDA,
    plain version on CPU."""
    if residual.device.type == "cpu":
        return apply_pc_keff_fused_plain(
            model, table, residual, stiffness_scale, mass_factor,
            with_dots=with_dots, reduction_dtype=reduction_dtype,
        )
    library, dev = _launch_args(model, residual)
    _build.check_tensor(table, "pc_table", (6, 3, 3, 3), torch.float32, dev)
    _build.check_aligned(model.bc_mask, "bc_mask", 4)
    taps = sweep_taps32(model)
    X, Y, Z = model.grid_shape
    geom = plane_sweep.sweep_geometry(model.grid_shape, 1)
    u = torch.empty_like(residual)
    w = torch.empty_like(residual)
    # (r,u), (r,r), (w,u) partials, one triple per block
    partials = (
        torch.empty(geom.partials_shape, dtype=torch.float32, device=dev)
        if with_dots else None
    )
    library.call(
        "civi_pc_keff_structured", dev, table.data_ptr(),
        model.stencil_table.data_ptr(), taps.ctypes.data,
        residual.data_ptr(), model.bc_mask.data_ptr(), u.data_ptr(),
        w.data_ptr(), partials.data_ptr() if with_dots else None,
        X, Y, Z, model.nx, model.ny, model.nz,
        float(np.float32(stiffness_scale)), float(np.float32(mass_factor)),
        float(np.float32(model.m8)), *geom.launch_args(),
        plane_sweep.vector_copies(Z, residual),
    )
    apply_pc_keff_fused.launches += 1
    if not with_dots:
        return u, w
    gamma, rr, delta = partials.to(reduction_dtype).sum(dim=1)
    return u, w, (gamma, delta, rr)


apply_pc_keff_fused.launches = 0
