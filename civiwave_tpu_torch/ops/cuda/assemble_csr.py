"""Wrapper of the assembly kernel G1, with its plain version.

G1, ``assemble_csr`` (``csrc/assemble_csr.cu``), is the second phase of the
general path's K_eff * x: the dual-CSR gather-sum of the element force rows
(civiwave_tpu/ops/apply_keff.py ``assemble`` :283), the lumped-mass term
and the Dirichlet identity rows (:400-401).  In the JAX package this phase
is XLA, not a Pallas kernel; it is a hand-written kernel here because its
plain PyTorch form is ``csr_degree`` full-size gathers.  It keeps the
reference's gather-based assembly with no float atomics: one thread sums
a node's slots in slot order, bit-equal to the plain version.  A block of
``ASSEMBLE_NODES`` nodes stages its slice of ``csr_idx`` and ``csr_weight``
into shared memory with coalesced 16-byte copies before the gathers
(:func:`staging_geometry`).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  f64 rows and x (``precision.vectors: fp64``) launch the f64
instance (weights and mass f32, widened; the staging is the same).
``assemble_keff.launches`` counts the f32 launches, ``.launches_f64`` the
f64 ones.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

# nodes (threads) per block; the shared memory is 2 * nodes * (D / 4 made
# odd) * 16 bytes, 28,672 at D = 24
ASSEMBLE_NODES = 128
SMEM_LIMIT = 232_448  # the most dynamic shared memory one H100 block may take


class StagingGeometry(NamedTuple):
    threads: int  # nodes per block, one thread each
    blocks: int
    row_chunks: int  # 16-byte chunks per staged CSR row: D / 4 made odd
    smem_bytes: int  # the staged csr_idx and csr_weight slices


def staging_geometry(nodes: int, degree: int) -> StagingGeometry:
    """The launch of G1 over ``nodes`` rows of a ``degree``-slot CSR: each
    block stages its rows of ``csr_idx`` and ``csr_weight`` as rows of an
    odd number of 16-byte chunks (so the eight threads of a quarter warp
    reading chunk q of eight rows hit distinct bank groups), halving the
    block below ``ASSEMBLE_NODES`` nodes if that would not fit."""
    if degree <= 0 or degree % 4:
        raise ValueError(f"csr_degree {degree} is not a positive multiple of 4")
    chunks = (degree // 4) | 1
    threads = ASSEMBLE_NODES
    while threads > 32 and 2 * threads * chunks * 16 > SMEM_LIMIT:
        threads //= 2
    smem = 2 * threads * chunks * 16
    if smem > SMEM_LIMIT:
        raise ValueError(f"csr_degree {degree}: a 32-node block needs {smem} "
                         f"bytes of shared memory, over {SMEM_LIMIT}")
    return StagingGeometry(threads, -(-int(nodes) // threads), chunks, smem)


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
    dtype = x.dtype
    entry = _build.instance("civi_assemble_csr", dtype)
    shape = model.vector_shape
    n, d = model.padded_node_count, model.csr_degree
    _build.check_tensor(x, "x", shape, dtype, dev)
    _build.check_tensor(model.bc_mask, "bc_mask", shape, torch.bool, dev)
    _build.check_tensor(rows, "rows", (model.force_row_count, 3), dtype, dev)
    _build.check_tensor(model.csr_idx, "csr_idx", (n, d), torch.int32, dev)
    _build.check_tensor(model.csr_weight, "csr_weight", (n, d), torch.float32, dev)
    _build.check_tensor(model.lumped_mass, "lumped_mass", (n,), torch.float32, dev)
    geom = staging_geometry(n, d)
    # CSR slices move as 16-byte copies; force rows as 8 + 4 bytes (f64:
    # 16 + 8)
    _build.check_aligned(model.csr_idx, "csr_idx", 16)
    _build.check_aligned(model.csr_weight, "csr_weight", 16)
    _build.check_aligned(rows, "rows", 2 * rows.element_size())
    library = _build.load_library()
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        code = getattr(library.lib, entry)(
            rows.data_ptr(), model.csr_idx.data_ptr(),
            model.csr_weight.data_ptr(), model.lumped_mass.data_ptr(),
            x.data_ptr(), model.bc_mask.data_ptr(), out.data_ptr(), n, d,
            float(mass_factor), *geom, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(library, "assemble_csr", code)
    _build.count_launch(assemble_keff, dtype)
    return out


assemble_keff.launches = 0
assemble_keff.launches_f64 = 0
