"""Wrapper of the assembly kernel G1, with its plain version.

G1, ``assemble_csr`` (``csrc/assemble_csr.cu``), is the second phase of the
general path's K_eff * x: the dual-CSR gather-sum of the element force rows
(civiwave_tpu/ops/apply_keff.py ``assemble`` :283), the lumped-mass term
and the Dirichlet identity rows (:400-401).  In the JAX package this phase
is XLA, not a Pallas kernel; it is a hand-written kernel here because its
plain PyTorch form is ``csr_degree`` full-size gathers.  It keeps the
reference's gather-based assembly with no float atomics.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  ``assemble_keff.launches`` counts launches.
"""

from __future__ import annotations

import torch

from . import _build


def assemble_keff_plain(model, rows, x, mass_factor):
    """Plain PyTorch ``bc ? x : assemble(rows) + mf m xs``."""
    from .. import apply_keff as ops

    return ops.finish_keff(model, ops.assemble(model, rows), x, mass_factor)


def assemble_keff(model, rows, x, mass_factor):
    """G1: (N*, 3) K_eff * x from the force rows; kernel on CUDA, plain
    version on CPU."""
    if x.device.type == "cpu":
        return assemble_keff_plain(model, rows, x, mass_factor)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    shape = model.vector_shape
    n, d = model.padded_node_count, model.csr_degree
    _build.check_tensor(x, "x", shape, torch.float32, dev)
    _build.check_tensor(model.bc_mask, "bc_mask", shape, torch.bool, dev)
    _build.check_tensor(
        rows, "rows", (model.force_row_count, 3), torch.float32, dev
    )
    _build.check_tensor(model.csr_idx, "csr_idx", (n, d), torch.int32, dev)
    _build.check_tensor(model.csr_weight, "csr_weight", (n, d), torch.float32, dev)
    _build.check_tensor(model.lumped_mass, "lumped_mass", (n,), torch.float32, dev)
    if d % 4:
        raise ValueError(f"csr_degree {d} is not a multiple of 4")
    # CSR rows are read as int4 / float4
    _build.check_aligned(model.csr_idx, "csr_idx", 16)
    _build.check_aligned(model.csr_weight, "csr_weight", 16)
    library = _build.load_library()
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        code = library.lib.civi_assemble_csr(
            rows.data_ptr(), model.csr_idx.data_ptr(),
            model.csr_weight.data_ptr(), model.lumped_mass.data_ptr(),
            x.data_ptr(), model.bc_mask.data_ptr(), out.data_ptr(), n, d,
            float(mass_factor), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(library, "assemble_csr", code)
    assemble_keff.launches += 1
    return out


assemble_keff.launches = 0
