"""Wrappers of the element-force kernel K7, with its plain version.

K7, ``element_forces`` (``csrc/element_forces.cu``), replaces the Pallas
kernels ``hex_force_streams`` / ``tet_force_streams`` (civiwave_tpu/ops/
pallas/element_forces.py:125, :130; pallas_call at :110): per element, the
gathered and sanitized corner displacements, the displacement gradient G,
the stress S = V ss (lam tr G I + mu (G + G^T)) and the local forces
f_l = grad_l^T S, written as force rows ``e * NL + l`` of the element's
block.  One template, two instances: ``tet_element_forces`` (4 nodes, one
point) and ``hex_element_forces`` (8 nodes, 2x2x2 Gauss points).

A CPU tensor takes the plain version (``ops/apply_keff.py``: sanitize, then
the stream math); a CUDA tensor launches the kernel or raises (f32 or f64
x, contiguous tables of the model's shapes).  f64 x
(``precision.vectors: fp64``) launches the f64 instance and gets f64 force
rows; the packed tables stay f32.  Each wrapper counts its launches in
``<wrapper>.launches`` (f32) and ``.launches_f64``, plain ints that only a
launch increments.
"""

from __future__ import annotations

import torch

from . import _build

# block -> (nodes per element, Gauss points)
_BLOCKS = {"tet": (4, 1), "hex": (8, 8)}


def _tables(model, block: str):
    if block == "tet":
        return (model.conn_tet, model.grads_tet, model.vol_tet, model.lam_tet,
                model.mu_tet, model.padded_tet_count)
    return (model.conn_hex, model.grads_hex, model.vol_hex, model.lam_hex,
            model.mu_hex, model.padded_hex_count)


def element_forces_plain(model, x, stiffness_scale, block: str):
    """Plain PyTorch force rows (E* * NL, 3) of one block from raw x."""
    from .. import apply_keff as ops

    forces = ops.tet_forces if block == "tet" else ops.hex_forces
    return forces(model, ops.sanitize(model, x), stiffness_scale)


def _launch(model, x, stiffness_scale, block: str, out):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    n_local, n_gp = _BLOCKS[block]
    conn, grads, vol, lam, mu, e = _tables(model, block)
    dtype = x.dtype
    entry = _build.instance(f"civi_element_forces_{block}", dtype)
    shape = model.vector_shape
    _build.check_tensor(x, "x", shape, dtype, dev)
    _build.check_tensor(model.bc_mask, "bc_mask", shape, torch.bool, dev)
    _build.check_tensor(conn, f"conn_{block}", (e, n_local), torch.int32, dev)
    grads_shape = (n_local, 3, e) if block == "tet" else (n_gp, n_local, 3, e)
    _build.check_tensor(grads, f"grads_{block}", grads_shape, torch.float32, dev)
    vol_shape = (e,) if block == "tet" else (n_gp, e)
    _build.check_tensor(vol, f"vol_{block}", vol_shape, torch.float32, dev)
    _build.check_tensor(lam, f"lam_{block}", (e,), torch.float32, dev)
    _build.check_tensor(mu, f"mu_{block}", (e,), torch.float32, dev)
    if out is None:
        out = torch.empty((e * n_local, 3), dtype=dtype, device=dev)
    _build.check_tensor(out, "rows", (e * n_local, 3), dtype, dev)
    # the kernel reads conn rows as int4 and stores force rows as float4
    # (double2 for f64)
    _build.check_aligned(conn, f"conn_{block}", 16)
    _build.check_aligned(out, "rows", 16)
    library = _build.load_library()
    fn = getattr(library.lib, entry)
    with torch.cuda.device(dev):
        code = fn(
            x.data_ptr(), model.bc_mask.data_ptr(), conn.data_ptr(),
            grads.data_ptr(), vol.data_ptr(), lam.data_ptr(), mu.data_ptr(),
            out.data_ptr(), e, float(stiffness_scale),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(library, f"element_forces_{block}", code)
    return out


def tet_element_forces(model, x, stiffness_scale, out=None):
    """K7 (tet4): force rows (T* * 4, 3); kernel on CUDA, plain on CPU.
    ``out`` (CUDA only) is the tensor the kernel writes into."""
    if x.device.type == "cpu":
        return element_forces_plain(model, x, stiffness_scale, "tet")
    out = _launch(model, x, stiffness_scale, "tet", out)
    _build.count_launch(tet_element_forces, x.dtype)
    return out


def hex_element_forces(model, x, stiffness_scale, out=None):
    """K7 (hex8): force rows (H* * 8, 3); kernel on CUDA, plain on CPU.
    ``out`` (CUDA only) is the tensor the kernel writes into."""
    if x.device.type == "cpu":
        return element_forces_plain(model, x, stiffness_scale, "hex")
    out = _launch(model, x, stiffness_scale, "hex", out)
    _build.count_launch(hex_element_forces, x.dtype)
    return out


tet_element_forces.launches = 0
tet_element_forces.launches_f64 = 0
hex_element_forces.launches = 0
hex_element_forces.launches_f64 = 0


def element_force_rows(model, x, stiffness_scale):
    """(R, 3) force rows of both blocks (tet rows first, then hex), the
    table the assembly gathers: one K7 launch per non-empty block on CUDA,
    the plain versions on CPU."""
    if x.device.type == "cpu":
        from .. import apply_keff as ops

        return ops.element_force_rows(model, ops.sanitize(model, x), stiffness_scale)
    rows = torch.empty((model.force_row_count, 3), dtype=x.dtype, device=x.device)
    split = model.padded_tet_count * 4
    if model.padded_tet_count:
        tet_element_forces(model, x, stiffness_scale, out=rows[:split])
    if model.padded_hex_count:
        hex_element_forces(model, x, stiffness_scale, out=rows[split:])
    return rows
