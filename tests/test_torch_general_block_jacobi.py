"""The port's general-path block-Jacobi against the JAX package.

Node blocks, their regularized inverses (all three rungs of the
reference's ladder) and the apply, on models carried across through
``convert`` (same node order) and, for the node blocks, on the port's own
pack in nodal order.  The block algebra is the same f32 arithmetic in both
packages; tolerances are f32 rounding of sums taken in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from civiwave_tpu.ops import block_jacobi as jbj
from civiwave_tpu_torch.ops import block_jacobi as bj
from torch_general_support import model_pair, to_port_packed

torch.set_num_threads(2)

KINDS = ["tet", "hex", "shuffled", "mixed", "column"]
SS, MF = np.float32(1.0000727), np.float32(4.0003636e6)


@pytest.mark.parametrize("kind", KINDS)
def test_node_blocks_and_inverse_match_the_reference(kind):
    (_, _, _, tm, _), (_, _, _, jm, _) = model_pair(kind)
    # the port's own pack, compared per node in nodal order
    ours = tm.assemble_node_blocks(SS, MF)
    ref = np.asarray(jm.assemble_node_blocks(SS, MF))
    ours_n = tm.to_nodal(ours.reshape(-1, 9)).numpy()
    ref_n = np.asarray(jm.to_nodal(jnp.asarray(ref.reshape(-1, 9))))
    np.testing.assert_allclose(
        ours_n, ref_n, rtol=1e-5, atol=1e-6 * np.abs(ref_n).max()
    )
    # the carried model: same node order, inverse and apply
    cm = to_port_packed(jm)
    inv = bj.build_block_jacobi_inverse(cm, SS, MF)
    jinv = np.asarray(jbj.build_block_jacobi_inverse(jm, SS, MF))
    np.testing.assert_allclose(
        inv.numpy(), jinv, rtol=1e-5, atol=1e-6 * np.abs(jinv).max()
    )
    r = np.random.default_rng(8).standard_normal(cm.vector_shape).astype(np.float32)
    z = bj.apply_preconditioner(cm, inv, torch.as_tensor(r)).numpy()
    jz = np.asarray(jbj.apply_preconditioner(jm, jnp.asarray(jinv), jnp.asarray(r)))
    np.testing.assert_allclose(z, jz, rtol=1e-5, atol=1e-6 * np.abs(jz).max())
    # constrained outputs are +0.0 by select
    zb = z[cm.bc_mask.numpy()]
    assert not zb.any() and not np.signbit(zb).any()


def _ladder_blocks(dtype):
    return np.array([
        # rung 1: regular SPD
        [[4.0, 1.0, 0.0], [1.0, 3.0, 0.5], [0.0, 0.5, 2.0]],
        # rung 2: singular (rank 2); +eps on the diagonal makes it invertible
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 0.0]],
        # rung 2 with a large diagonal: eps scales with max_diag
        [[1.0e10, 1.0e10, 0.0], [1.0e10, 1.0e10, 0.0], [0.0, 0.0, 5.0]],
        # rung 3: all zero; the retry stays singular -> diagonal-only
        [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
        # rung 3 with a tiny diagonal
        [[1.0e-9, 0.0, 0.0], [0.0, 1.0e-9, 0.0], [0.0, 0.0, 1.0e-9]],
    ], dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_invert_spd_3x3_ladder_matches_the_reference(dtype):
    blocks = _ladder_blocks(dtype)
    ours = bj.invert_spd_3x3(torch.as_tensor(blocks)).numpy()
    ref = np.asarray(jbj.invert_spd_3x3(jnp.asarray(blocks)))
    assert ours.dtype == ref.dtype == dtype
    np.testing.assert_allclose(ours, ref, rtol=1e-6 if dtype == np.float32 else 1e-12)
    # rung 1 is the true inverse; rung 3 is 1 / max(d_ii, 1e-6) on the diagonal
    np.testing.assert_allclose(ours[0] @ blocks[0], np.eye(3), atol=1e-5)
    np.testing.assert_allclose(np.diag(ours[3]), 1.0 / 1.0e-6 * np.ones(3), rtol=1e-5)
    assert not (ours[3] - np.diag(np.diag(ours[3]))).any()
    # rung 2 is the inverse of the regularized block
    eps = max(1.0e-6, 1.0 * 1.0e-6 + 1.0e-12)
    np.testing.assert_allclose(
        ours[1], np.linalg.inv(blocks[1].astype(np.float64) + eps * np.eye(3)),
        rtol=1e-5,
    )
