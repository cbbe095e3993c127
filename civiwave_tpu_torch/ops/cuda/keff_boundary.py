"""Wrapper of the boundary/envelope kernel G2, with its plain version.

G2, ``keff_boundary`` (``csrc/keff_boundary.cu``), stands for the XLA code
the reference runs around ``interior_stencil_pallas`` (K4) on its slender
route (civiwave_tpu/ops/structured.py:449-471 and :607-609): from K4's
output it makes the complete operator,
``bc ? x : ss * (interior - corr) + mf * mass * xs``, where ``corr`` is
each boundary node's ghost taps (``ops/structured.ghost_stencil_table``)
applied to the sanitized neighbours.  One pass, one thread per node.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  ``keff_boundary.launches`` counts launches.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _build


def keff_boundary_plain(model, interior, x, stiffness_scale, mass_factor):
    """Plain PyTorch G2: the reference's face corrections (edge and corner
    terms folded in) subtracted from ``interior``, then scale, mass term
    and identity rows."""
    from ..structured import keff_envelope, subtract_face_corrections

    xs = x.masked_fill(model.bc_mask, 0.0)
    stiff = subtract_face_corrections(model, xs, interior.clone())
    return keff_envelope(model, x, xs, stiff, stiffness_scale, mass_factor)


@lru_cache(maxsize=16)
def _ghost_table(spacing, lam0: float, mu0: float, device) -> torch.Tensor:
    """The (27, 27, 3, 3) ghost taps on ``device``, uploaded once."""
    from ..structured import ghost_stencil_table

    return torch.as_tensor(ghost_stencil_table(spacing, lam0, mu0), device=device)


def keff_boundary(model, interior, x, stiffness_scale, mass_factor):
    """G2: K_eff * x from K4's ``interior`` = stencil(xs); kernel on CUDA,
    plain version on CPU."""
    if x.device.type == "cpu":
        return keff_boundary_plain(
            model, interior, x, stiffness_scale, mass_factor
        )
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    shape = model.vector_shape
    _build.check_tensor(interior, "interior", shape, torch.float32, dev)
    _build.check_tensor(x, "x", shape, torch.float32, dev)
    _build.check_tensor(model.bc_mask, "bc_mask", shape, torch.bool, dev)
    ghost = _ghost_table(model.spacing, model.lam0, model.mu0, dev)
    library = _build.load_library()
    out = torch.empty_like(x)
    X, Y, Z = model.grid_shape
    with torch.cuda.device(dev):
        code = library.lib.civi_keff_boundary(
            interior.data_ptr(), x.data_ptr(), model.bc_mask.data_ptr(),
            ghost.data_ptr(), out.data_ptr(),
            X, Y, Z, model.nx, model.ny, model.nz,
            float(np.float32(stiffness_scale)), float(np.float32(mass_factor)),
            float(np.float32(model.m8)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(library, "keff_boundary", code)
    keff_boundary.launches += 1
    return out


keff_boundary.launches = 0
