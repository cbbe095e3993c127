"""Wrapper of the shard operator kernel K5, with its plain version.

K5, ``keff_structured_halo`` (``csrc/keff_structured_halo.cu``), replaces
the Pallas kernel ``apply_keff_fused_pallas_padded`` in its sharded forms
(civiwave_tpu/ops/pallas/structured_stencil.py:968, pallas_calls at
:1041/:1068, driven from ops/structured_sharded.py): the complete
``bc ? x : ss * K(xs) + mf * mass * xs`` on one shard's ``(3, Xl, Yl, Z)``
block, over a range of its X planes, with the neighbours beyond the block
read from exchanged ghost buffers (an ``ops.structured_sharded.Ghosts``):

* X ghost planes ``(3, Yl + 2 gy, Z)`` below plane 0 and above plane
  Xl - 1 — in the 2-D (X, Y) decomposition (gy = 1) Y-extended, their end
  rows carrying the diagonal neighbours' corners;
* in 2-D, Y ghost rows ``(3, Xl, Z)`` below row 0 and above row Yl - 1.

The mask's ghosts are the model's ``bc_ghosts`` (exchanged once, at shard
time).  A ghost that is None reads as zero and free.  A node's taps and
mass come from its boundary class at its global coordinate (``x0 + ix``,
``y0 + iy``), so the reference's face indices and ownership scalars have
no counterpart.  The kernel is a plane sweep (``plane_sweep.py``) over the
plane range; the halo planes next to the range come from the block where
they lie inside it, so the overlap split's interior launch reads no X
ghost.  Every cut, gathered, equals the whole grid bit for bit, and the
split's three launches equal one.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises (f32 or f64, contiguous, the shard's shapes).  An f64 vector
(``precision.vectors: fp64``) launches the kernel's f64 instance, with
ss and mf in f64 as the plain version takes them; f32 vectors round both
to f32.  ``keff_structured_halo.launches`` counts the f32 launches and
``.launches_f64`` the f64 ones.  K1 (``structured_stencil.apply_keff_fused``)
launches the same kernel through :func:`launch_operator` on a whole grid
with no ghosts, and counts its own.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, plane_sweep


def _ghost_y(model) -> int:
    """1 in the 2-D (X, Y) decomposition (the mask has Y ghost rows)."""
    g = model.bc_ghosts
    return int(g is not None and (g.y_lo is not None or g.y_hi is not None))


def _planes(model, planes):
    xl = model.grid_shape[0]
    p0, p1 = (0, xl) if planes is None else (int(planes[0]), int(planes[1]))
    if not 0 <= p0 <= p1 <= xl:
        raise ValueError(f"plane range [{p0}, {p1}) outside [0, {xl})")
    return p0, p1


def _ghost_padded(block, ghosts, gy: int):
    """The block with a one-node frame: the ghosts on the X (and in 2-D
    the Y) sides, zero elsewhere (Z ends, missing ghosts)."""
    _, xl, yl, z = block.shape
    full = block.new_zeros((3, xl + 2, yl + 2, z + 2))
    full[:, 1:-1, 1:-1, 1:-1] = block
    if ghosts is None:
        return full
    rows = slice(None) if gy else slice(1, -1)  # the X planes' Y extent
    for plane, g in ((0, ghosts.x_lo), (xl + 1, ghosts.x_hi)):
        if g is not None:
            full[:, plane, rows, 1:-1] = g
    if gy:
        for row, g in ((0, ghosts.y_lo), (yl + 1, ghosts.y_hi)):
            if g is not None:
                full[:, 1:-1, row, 1:-1] = g
    return full


def keff_structured_halo_plain(
    model, x, ghosts, stiffness_scale, mass_factor, planes=None, out=None
):
    """Plain PyTorch K5: the sanitized ghost-padded block through each
    node's 27 class taps as shifted slices, then the mass term and the
    identity rows, on planes ``[p0, p1)`` of ``out`` (new if None).  ss and
    mf are rounded to f32 for f32 vectors only."""
    from ..structured import axis_classes

    _, yl, z = model.grid_shape
    p0, p1 = _planes(model, planes)
    gy = _ghost_y(model)
    xs = _ghost_padded(x, ghosts, gy).masked_fill(
        _ghost_padded(model.bc_mask, model.bc_ghosts, gy), 0.0
    )
    dev = x.device
    cls = torch.as_tensor(
        (axis_classes(p1 - p0, model.nx, model.x0 + p0)[:, None, None] * 3
         + axis_classes(yl, model.ny, model.y0)[None, :, None]) * 3
        + axis_classes(z, model.nz)[None, None, :],
        device=dev,
    )
    table = model.stencil_table.to(device=dev, dtype=x.dtype)
    acc = x.new_zeros((3, p1 - p0, yl, z))
    for d in np.ndindex(3, 3, 3):
        win = xs[:, p0 + d[0]:p1 + d[0], d[1]:d[1] + yl, d[2]:d[2] + z]
        taps = table[:, (d[0] * 3 + d[1]) * 3 + d[2]][cls]  # (P, Yl, Z, 3, 3)
        for b in range(3):
            acc[b] += (taps[..., b, 0] * win[0] + taps[..., b, 1] * win[1]
                       + taps[..., b, 2] * win[2])
    own = xs[:, p0 + 1:p1 + 1, 1:-1, 1:-1]
    mass = model.mass_grid[p0:p1].to(x.dtype) * _build.scalar(mass_factor, x.dtype)
    res = acc * _build.scalar(stiffness_scale, x.dtype) + mass[None] * own
    if out is None:
        out = torch.empty_like(x)
    out[:, p0:p1] = torch.where(model.bc_mask[:, p0:p1], x[:, p0:p1], res)
    return out


def launch_operator(model, x, ghosts, planes, out, stiffness_scale,
                    mass_factor, name):
    """Check the operands and launch the operator kernel once on planes
    ``planes`` (None: all) of ``out`` (new if None), which is returned.
    ``ghosts`` is a shard's (an ``ops.structured_sharded.Ghosts``) or None
    on a whole grid.  The kernel is the plane sweep of ``plane_sweep.py``
    over that range; it takes the model's ``sweep_taps`` by value (f64
    vectors: the f64 instance with ``plane_sweep.sweep_taps64``).  Raises
    on a launch error; the caller counts the launch."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _build.check_homogeneous(model, name)
    dtype = x.dtype
    entry = _build.instance("civi_keff_structured_halo", dtype)
    xl, yl, z = model.grid_shape
    shape = model.vector_shape
    _build.check_tensor(x, "vector", shape, dtype, dev)
    _build.check_tensor(model.bc_mask, "bc_mask", shape, torch.bool, dev)
    _build.check_tensor(
        model.stencil_table, "stencil_table", (27, 27, 3, 3), torch.float32,
        dev,
    )
    # mask rows are staged as aligned 4-byte words
    _build.check_aligned(model.bc_mask, "bc_mask", 4)
    taps = (plane_sweep.sweep_taps32(model) if dtype == torch.float32
            else plane_sweep.sweep_taps64(model))
    gy = _ghost_y(model)
    ptrs = []  # each side's values, then its mask; None reads as zero
    for side in ("x_lo", "x_hi") + (("y_lo", "y_hi") if gy else ()):
        gshape = (3, yl + 2 * gy, z) if side[0] == "x" else (3, xl, z)
        for g, gtype in ((getattr(ghosts, side, None), dtype),
                         (getattr(model.bc_ghosts, side, None), torch.bool)):
            if g is not None:
                _build.check_tensor(g, f"ghost {side}", gshape, gtype, dev)
                if gtype == torch.bool:
                    _build.check_aligned(g, f"ghost {side} mask", 4)
            ptrs.append(None if g is None else g.data_ptr())
    ptrs += [None] * (8 - len(ptrs))
    p0, p1 = _planes(model, planes)
    geom = plane_sweep.sweep_geometry(model.grid_shape, 1, (p0, p1),
                                      elem=x.element_size())
    if out is None:
        out = torch.empty_like(x)
    _build.check_tensor(out, "out", shape, dtype, dev)
    library = _build.load_library()
    library.call(
        entry, dev, x.data_ptr(), model.bc_mask.data_ptr(), *ptrs,
        model.stencil_table.data_ptr(), taps.ctypes.data, out.data_ptr(),
        xl, yl, z, gy, model.x0, model.y0, model.nx, model.ny, model.nz,
        p0, p1, _build.scalar(stiffness_scale, dtype),
        _build.scalar(mass_factor, dtype), float(np.float32(model.m8)),
        *geom.launch_args(), plane_sweep.vector_copies(z, x),
    )
    return out


def keff_structured_halo(
    model, x, ghosts, stiffness_scale, mass_factor, planes=None, out=None
):
    """K5: planes ``[p0, p1)`` (default all) of the shard's K_eff * x into
    ``out`` (new if None), which is returned; kernel on CUDA, plain version
    on CPU."""
    if x.device.type == "cpu":
        return keff_structured_halo_plain(
            model, x, ghosts, stiffness_scale, mass_factor, planes, out
        )
    out = launch_operator(model, x, ghosts, planes, out, stiffness_scale,
                          mass_factor, "keff_structured_halo")
    _build.count_launch(keff_structured_halo, x.dtype)
    return out


keff_structured_halo.launches = 0
keff_structured_halo.launches_f64 = 0
