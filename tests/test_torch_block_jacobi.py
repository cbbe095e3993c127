"""Class-table block-Jacobi preconditioner of the port against the JAX
reference: node blocks, the regularized 3x3 inverse, the (6, 3, 3, 3)
class table and its apply (the plain form, the reference's XLA form and
Pallas kernel in interpret mode, and a numpy emulation of the K3 CUDA
kernel's per-node arithmetic).  Tolerance: 1e-6 * max|ref|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from civiwave_tpu.ops import structured as jops
from civiwave_tpu.ops.pallas.block_jacobi_apply import apply_block_jacobi_pallas
from civiwave_tpu_torch import convert
from civiwave_tpu_torch.ops import structured as tops
from civiwave_tpu_torch.ops.cuda import block_jacobi_apply as k3

from test_torch_structured import CASES, build_pair

torch.set_num_threads(2)

PC_TOL = 1e-6
SS, MF = np.float32(1.3), np.float32(4.0e6)


def emulate_block_jacobi(model, table, r):
    """numpy emulation of the K3 kernel: each node picks its 6 coefficients
    by its per-axis class and applies the symmetric 3x3; constrained
    components are +0.0 by select."""
    t = np.asarray(table, np.float64).reshape(6, 27)
    _, X, Y, Z = r.shape
    cls = (
        tops.axis_classes(X, model.nx)[:, None, None] * 9
        + tops.axis_classes(Y, model.ny)[None, :, None] * 3
        + tops.axis_classes(Z, model.nz)[None, None, :]
    )
    c00, c11, c22, c01, c02, c12 = (t[m][cls] for m in range(6))
    r0, r1, r2 = np.asarray(r, np.float64)
    z = np.stack([
        c00 * r0 + c01 * r1 + c02 * r2,
        c01 * r0 + c11 * r1 + c12 * r2,
        c02 * r0 + c12 * r1 + c22 * r2,
    ])
    return np.where(model.bc_mask.numpy(), 0.0, z)


def _close(out, ref, rel=PC_TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(
        out, ref, rtol=0.0, atol=rel * (np.abs(ref).max() + 1e-30)
    )


@pytest.mark.parametrize("case", ["fixes", "xpad", "nx1", "ny1_nz1"])
def test_blocks_table_and_apply_match_reference(case):
    dims, kw = CASES[case]
    jm, _, tm, _ = build_pair(dims, kw)
    _close(
        tm.assemble_node_blocks(SS, MF).numpy(),
        np.asarray(jm.assemble_node_blocks(SS, MF)),
    )
    full_j = np.asarray(jops.build_block_jacobi_inverse_structured(jm, SS, MF))
    _close(tops.build_block_jacobi_inverse_structured(tm, SS, MF).numpy(), full_j)
    pc_j = jm.build_preconditioner(SS, MF)
    pc_t = tm.build_preconditioner(SS, MF)
    assert isinstance(pc_t, tops.CompactBlockJacobi)
    assert pc_t.table.shape == (6, 3, 3, 3)
    _close(pc_t.table.numpy(), np.asarray(pc_j.table))

    r = np.random.default_rng(5).standard_normal(jm.vector_shape).astype(np.float32)
    ref = np.asarray(jm.apply_preconditioner(pc_j, jnp.asarray(r)))
    z = tm.apply_preconditioner(pc_t, torch.from_numpy(r)).numpy()
    _close(z, ref)
    # constrained components are +0.0 (select, not multiply)
    bc = tm.bc_mask.numpy()
    assert not np.signbit(z[bc]).any() and not z[bc].any()
    # the K3 kernel's per-node arithmetic, on the reference's own table
    _close(emulate_block_jacobi(tm, np.asarray(pc_j.table), r), ref)
    # the class table reproduces the full per-node inverse everywhere
    _close(emulate_block_jacobi(tm, pc_t.table.numpy(), r),
           np.asarray(jops.apply_preconditioner_structured(
               jm, jnp.asarray(full_j), jnp.asarray(r))))


def test_apply_matches_pallas_interpret_kernel():
    dims, kw = CASES["fixes"]
    jm, _, tm, _ = build_pair(dims, kw)
    pc_j = jm.build_preconditioner(SS, MF)
    pc_t = convert.compact_pc_from_array(np.asarray(pc_j.table), "cpu")
    r = np.random.default_rng(9).standard_normal(jm.vector_shape).astype(np.float32)
    ref = np.asarray(apply_block_jacobi_pallas(
        jm, pc_j.table, jnp.asarray(r), interpret=True
    ))
    _close(k3.apply_block_jacobi(tm, pc_t.table, torch.from_numpy(r)).numpy(), ref)
    _close(emulate_block_jacobi(tm, pc_t.table.numpy(), r), ref)


def test_regularized_inverse_matches_reference_on_singular_blocks():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 3, 4)).astype(np.float32)
    blocks = np.einsum("ikn,jkn->ijn", a, a).astype(np.float32)  # SPD
    blocks[:, :, 1] = 0.0  # singular: regularized by epsilon
    blocks[:, :, 2] = np.outer([1, 2, 3], [1, 2, 3]).astype(np.float32)  # rank 1
    blocks[:, :, 3] = np.diag([5e-7, 0.0, 0.0]).astype(np.float32)  # tiny
    ref = np.asarray(jops._invert_spd_3x3_lead(jnp.asarray(blocks)))
    ours = tops._invert_spd_3x3_lead(torch.from_numpy(blocks)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0.0)
