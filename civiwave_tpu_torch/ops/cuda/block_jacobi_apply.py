"""Wrapper of the class-table block-Jacobi kernel K3, with its plain
version.

K3, ``block_jacobi_apply`` (``csrc/block_jacobi_apply.cu``), replaces the
Pallas kernel ``apply_block_jacobi_pallas`` (civiwave_tpu/ops/pallas/
block_jacobi_apply.py:144, pallas_call at :170): ``z = M^-1 r`` from the
(6, 3, 3, 3) class table, +0.0 by select on constrained components.  The
classic PCG variant applies it once per iteration, the Chronopoulos-Gear
loop of a shard once per iteration too.  A shard's nodes are classified by
their global coordinates: the wrapper passes the model's offsets
``x0``/``y0`` (0 on an unsharded model).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  f64 residuals (``precision.vectors: fp64``) launch the kernel's f64
instance (the f32 table widened, as the plain form does).
``apply_block_jacobi.launches`` counts the f32 launches,
``.launches_f64`` the f64 ones.
"""

from __future__ import annotations

import torch

from . import _build


def apply_block_jacobi_plain(model, table, residual):
    """Plain PyTorch class-table apply (the reference's XLA form)."""
    from ..structured import apply_compact_preconditioner_structured_plain

    return apply_compact_preconditioner_structured_plain(model, table, residual)


def apply_block_jacobi(model, table, residual):
    """K3: z = M^-1 r; kernel on CUDA, plain version on CPU."""
    if residual.device.type == "cpu":
        return apply_block_jacobi_plain(model, table, residual)
    dev = residual.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    dtype = residual.dtype
    entry = _build.instance("civi_block_jacobi_apply", dtype)
    shape = model.vector_shape
    _build.check_tensor(residual, "residual", shape, dtype, dev)
    _build.check_tensor(model.bc_mask, "bc_mask", shape, torch.bool, dev)
    _build.check_tensor(table, "pc_table", (6, 3, 3, 3), torch.float32, dev)
    library = _build.load_library()
    z = torch.empty_like(residual)
    X, Y, Z = model.grid_shape
    with torch.cuda.device(dev):
        code = getattr(library.lib, entry)(
            table.data_ptr(), residual.data_ptr(), model.bc_mask.data_ptr(),
            z.data_ptr(), X, Y, Z, model.nx, model.ny, model.nz,
            model.x0, model.y0, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(library, "block_jacobi_apply", code)
    _build.count_launch(apply_block_jacobi, dtype)
    return z


apply_block_jacobi.launches = 0
apply_block_jacobi.launches_f64 = 0
