"""Wrapper of the interior-stencil kernel K4, with its plain version.

K4, ``interior_stencil`` (``csrc/interior_stencil.cu``), replaces the Pallas
kernel ``interior_stencil_pallas`` (civiwave_tpu/ops/pallas/
structured_stencil.py:110, pallas_call at :127): the constant interior
27-tap block stencil ``out[b][n] = sum_d sum_c T[d][b][c] * xs[c][n+d]``
on a sanitized (3, X, Y, Z) f32 vector, zero padded on all six sides.  It
is the first half of the slender route's operator; G2
(``keff_boundary``) completes it.  The kernel is a plane sweep along X
through shared memory whose (y, z) tile and chunk
``plane_sweep.stencil_geometry`` chooses from the grid's shape.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises (f32 only, contiguous, (3, X, Y, Z)).  ``interior_stencil.launches``
counts launches.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, plane_sweep


def interior_stencil_plain(xs: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Plain PyTorch K4: the shifted-window stencil of the reference's XLA
    form (``ops/structured._apply_taps``)."""
    from ..structured import _apply_taps

    return _apply_taps(xs, taps)


def interior_stencil(xs: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """K4: the interior stencil ``taps`` (3, 3, 3, 3, 3) — (dx+1, dy+1,
    dz+1, b, c) — applied to ``xs``; kernel on CUDA, plain version on CPU."""
    if xs.device.type == "cpu":
        return interior_stencil_plain(xs, taps)
    if xs.dim() != 4:
        raise ValueError(f"xs: shape {tuple(xs.shape)}, expected (3, X, Y, Z)")
    return launch(xs, taps, plane_sweep.stencil_geometry(xs.shape[1:]))


def launch(xs: torch.Tensor, taps: np.ndarray, geom) -> torch.Tensor:
    """One launch of K4 on the CUDA tensor ``xs`` with the sweep geometry
    ``geom`` (``interior_stencil`` passes the shape's own; a measurement
    may pass another candidate), counted in ``interior_stencil.launches``."""
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if xs.dim() != 4 or xs.shape[0] != 3:
        raise ValueError(f"xs: shape {tuple(xs.shape)}, expected (3, X, Y, Z)")
    _build.check_tensor(xs, "xs", xs.shape, torch.float32, dev)
    t32 = np.ascontiguousarray(taps, dtype=np.float32)
    if t32.shape != (3, 3, 3, 3, 3):
        raise ValueError(f"taps: shape {t32.shape}, expected (3, 3, 3, 3, 3)")
    library = _build.load_library()
    out = torch.empty_like(xs)
    _, X, Y, Z = xs.shape
    library.call(
        "civi_interior_stencil", dev, xs.data_ptr(), t32.ctypes.data,
        out.data_ptr(), X, Y, Z, *geom.launch_args(),
        plane_sweep.vector_copies(Z, xs),
    )
    interior_stencil.launches += 1
    return out


interior_stencil.launches = 0
