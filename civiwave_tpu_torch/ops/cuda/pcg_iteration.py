"""Wrapper of the whole-iteration PCG kernel K6, with its plain version.

K6, ``pcg_iteration_structured`` (``csrc/pcg_iteration_structured.cu``),
replaces the Pallas kernel ``pcg_iteration_fused_pallas``
(civiwave_tpu/ops/pallas/structured_stencil.py:1226, pallas_call at :1285):
one Chronopoulos-Gear iteration on the six carries ``(x, r, u, w, p, s)``
of a homogeneous structured grid,

    p' = free ? u + beta p : 0        s' = free ? w + beta s : 0
    x' = x + alpha p'                 r' = r - alpha s'
    u' = M^-1 r'                      w' = K_eff u'

with the three dots ``(gamma, delta, rr) = ((r', u'), (w', u'), (r', r'))``
in the reduction dtype.  The carries are the plain ``(3, X, Y, Z)``
vectors: the reference's x_ext padding exists for its VMEM blocks and is
not ported.

A CPU tensor takes the plain version, which returns new tensors.  A CUDA
tensor launches the kernel or raises (f32 only, contiguous, shapes of the
model); the kernel updates x, u and p in place and returns fresh r', w'
and s' (neighbouring threads still read r, w and s), so the caller must
own the carries it passes.  ``pcg_iteration_fused.launches`` counts the
launches, a plain int that only a launch increments.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, plane_sweep
from .plane_sweep import sweep_taps32
from .structured_stencil import _launch_args


def pcg_iteration_fused_plain(
    model, table, carries, alpha, beta, stiffness_scale, mass_factor,
    reduction_dtype=torch.float64,
):
    """Plain PyTorch K6: the recurrence and axpys in torch ops, then the
    class-table apply, the plain operator and the three dots via
    fused_dots.  Returns ``((x, r, u, w, p, s), (gamma, delta, rr))``."""
    from ...solver.pcg import fused_dots
    from ..structured import (
        apply_compact_preconditioner_structured_plain,
        apply_keff_structured_plain,
    )

    x, r, u, w, p, s = carries
    bc = model.bc_mask
    p = (u + beta * p).masked_fill(bc, 0.0)
    s = (w + beta * s).masked_fill(bc, 0.0)
    x = x + alpha * p
    r = r - alpha * s
    u = apply_compact_preconditioner_structured_plain(model, table, r)
    w = apply_keff_structured_plain(model, u, stiffness_scale, mass_factor)
    gamma, delta, rr = fused_dots([(r, u), (w, u), (r, r)], reduction_dtype)
    return (x, r, u, w, p, s), (gamma, delta, rr)


def _scalar32(value, device) -> torch.Tensor:
    return torch.as_tensor(value, device=device).to(torch.float32).reshape(1)


def pcg_iteration_fused(
    model, table, carries, alpha, beta, stiffness_scale, mass_factor,
    reduction_dtype=torch.float64,
):
    """K6: one whole PCG iteration; kernel on CUDA, plain version on CPU.
    ``alpha``/``beta`` may be Python floats or 0-d tensors (device tensors
    stay on the device: the kernel reads them there, no host sync)."""
    x, r, u, w, p, s = carries
    if x.device.type == "cpu":
        return pcg_iteration_fused_plain(
            model, table, carries, alpha, beta, stiffness_scale, mass_factor,
            reduction_dtype,
        )
    library, dev = _launch_args(model, x)
    for name, v in zip("ruwps", (r, u, w, p, s)):
        _build.check_tensor(v, name, model.vector_shape, torch.float32, dev)
    _build.check_tensor(table, "pc_table", (6, 3, 3, 3), torch.float32, dev)
    _build.check_aligned(model.bc_mask, "bc_mask", 4)
    taps = sweep_taps32(model)
    alpha_beta = torch.cat([_scalar32(alpha, dev), _scalar32(beta, dev)])
    X, Y, Z = model.grid_shape
    geom = plane_sweep.sweep_geometry(model.grid_shape, 3)
    r_new = torch.empty_like(r)
    w_new = torch.empty_like(w)
    s_new = torch.empty_like(s)
    # (r,u), (r,r), (w,u) partials, one triple per block
    partials = torch.empty(geom.partials_shape, dtype=torch.float32, device=dev)
    library.call(
        "civi_pcg_iteration_structured", dev, table.data_ptr(),
        model.stencil_table.data_ptr(), taps.ctypes.data,
        alpha_beta.data_ptr(), x.data_ptr(), r.data_ptr(), u.data_ptr(),
        w.data_ptr(), p.data_ptr(), s.data_ptr(), model.bc_mask.data_ptr(),
        r_new.data_ptr(), w_new.data_ptr(), s_new.data_ptr(),
        partials.data_ptr(), X, Y, Z, model.nx, model.ny, model.nz,
        float(np.float32(stiffness_scale)), float(np.float32(mass_factor)),
        float(np.float32(model.m8)), *geom.launch_args(),
        plane_sweep.vector_copies(Z, r, w, s),
    )
    pcg_iteration_fused.launches += 1
    gamma, rr, delta = partials.to(reduction_dtype).sum(dim=1)
    return (x, r_new, u, w_new, p, s_new), (gamma, delta, rr)


pcg_iteration_fused.launches = 0
