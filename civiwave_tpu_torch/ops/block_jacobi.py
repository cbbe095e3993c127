"""Block-Jacobi preconditioner of the general path: per-node 3x3 diagonal
blocks of K_eff.

Port of :mod:`civiwave_tpu.ops.block_jacobi` as plain PyTorch (a rebuild
of the reference engine's src/gpu/pcg.cpp:215-456).  It is not a Pallas
kernel in the reference: the build runs once per dt change (the stepper
hoists it) and the apply is a pointwise 3x3 product.

For the isotropic element stiffness the node-diagonal 3x3 block has the
closed form

    B_l = V * scale * [ (lam + mu) g_l (x) g_l + mu |g_l|^2 I ]

summed over the node's incident element rows with the same dual-CSR gather
the operator's assembly uses.  Inversion follows the reference's
regularization ladder exactly (invert_spd_3x3, pcg.cpp:215-268):

1. adjugate inverse when |det| >= 1e-12;
2. else add eps = max(1e-6, max_diag * 1e-6 + 1e-12) to the diagonal, retry;
3. else fall back to a diagonal-only inverse 1 / max(d_ii, 1e-6).

Constrained axes get identity rows (pcg.cpp:390-400) and the apply zeroes
constrained outputs, +0.0 by select (pcg.cpp:441-453).
"""

from __future__ import annotations

import torch

from ..mesh.pack import PackedModel

_DET_TOL = 1.0e-12


def _local_blocks(grads, vol_scale, lam, mu):
    """Per-(element[, gp], local-node) 3x3 diagonal blocks.

    grads: (..., L, 3); vol_scale/lam/mu broadcastable to (...,).
    Returns (..., L, 3, 3).
    """
    norm_sq = torch.einsum("...la,...la->...l", grads, grads)
    outer = torch.einsum("...la,...lb->...lab", grads, grads)
    eye = torch.eye(3, dtype=grads.dtype, device=grads.device)
    lam_mu = (lam + mu)[..., None]
    scale = vol_scale[..., None]
    return (scale * lam_mu)[..., None, None] * outer + (
        (scale * mu[..., None] * norm_sq)[..., None, None] * eye
    )


def assemble_node_blocks(
    model: PackedModel, stiffness_scale, mass_factor
) -> torch.Tensor:
    """Per-node 3x3 K_eff diagonal blocks, (N*, 3, 3) (pcg.cpp:270-378).
    The hex Gauss-point axis and the CSR slot axis are unrolled so no
    temporary carries an extra size-8 axis."""
    ss = float(stiffness_scale)
    parts = []
    if model.padded_tet_count:
        parts.append(
            _local_blocks(
                model.grads_tet.permute(2, 0, 1),  # (T*, 4l, 3)
                model.vol_tet * ss,
                model.lam_tet,
                model.mu_tet,
            ).reshape(-1, 3, 3)  # (T*4, 3, 3)
        )
    if model.padded_hex_count:
        acc = None
        for g in range(8):
            blocks_g = _local_blocks(
                model.grads_hex[g].permute(2, 0, 1),  # (H*, 8l, 3)
                model.vol_hex[g] * ss,
                model.lam_hex,
                model.mu_hex,
            )  # (H*, 8l, 3, 3)
            acc = blocks_g if acc is None else acc + blocks_g
        parts.append(acc.reshape(-1, 3, 3))
    rows = parts[0] if len(parts) == 1 else torch.cat(parts)

    idx = model.csr_idx.long()
    summed = None
    for d in range(model.csr_degree):
        term = rows[idx[:, d]] * model.csr_weight[:, d, None, None]
        summed = term if summed is None else summed + term

    eye = torch.eye(3, dtype=summed.dtype, device=summed.device)
    mass = (float(mass_factor) * model.lumped_mass)[:, None, None] * eye
    return summed + mass


def _det3(m: torch.Tensor) -> torch.Tensor:
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def _adjugate(m: torch.Tensor) -> torch.Tensor:
    """Transpose of the cofactor matrix, batched (pcg.cpp:256-267)."""
    return torch.stack(
        [
            m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1],
            m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2],
            m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1],
            m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2],
            m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0],
            m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2],
            m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0],
            m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1],
            m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0],
        ],
        dim=-1,
    ).reshape(*m.shape[:-2], 3, 3)


def invert_spd_3x3(blocks: torch.Tensor) -> torch.Tensor:
    """Regularized batched SPD 3x3 inverse (pcg.cpp:215-268)."""
    det = _det3(blocks)
    singular = det.abs() < _DET_TOL

    eye = torch.eye(3, dtype=blocks.dtype, device=blocks.device)
    diag = torch.diagonal(blocks, dim1=-2, dim2=-1)
    max_diag = diag.max(dim=-1).values
    epsilon = torch.clamp(max_diag * 1.0e-6 + 1.0e-12, min=1.0e-6)
    regularized = torch.where(
        singular[..., None, None], blocks + epsilon[..., None, None] * eye, blocks
    )
    det2 = _det3(regularized)
    still_singular = det2.abs() < _DET_TOL

    inv_det = 1.0 / torch.where(still_singular, 1.0, det2)
    inverse = _adjugate(regularized) * inv_det[..., None, None]

    reg_diag = torch.diagonal(regularized, dim1=-2, dim2=-1)
    diag_only = (1.0 / torch.clamp(reg_diag, min=1.0e-6))[..., :, None] * eye
    return torch.where(still_singular[..., None, None], diag_only, inverse)


def build_block_jacobi_inverse(
    model: PackedModel, stiffness_scale, mass_factor
) -> torch.Tensor:
    """(N*, 3, 3) inverse blocks with identity rows on constrained axes
    (pcg.cpp:479-503 + 390-400)."""
    blocks = model.assemble_node_blocks(stiffness_scale, mass_factor)
    inverse = invert_spd_3x3(blocks)
    eye = torch.eye(3, dtype=inverse.dtype, device=inverse.device)
    constrained = model.bc_mask[:, :, None]  # (N, 3, 1) broadcast over columns
    return torch.where(constrained, eye[None], inverse)


def apply_preconditioner(
    model: PackedModel, block_inverse: torch.Tensor, residual: torch.Tensor
) -> torch.Tensor:
    """z = M^-1 r with constrained outputs zeroed, +0.0 by select
    (pcg.cpp:410-456).  The 3x3 product is written elementwise (no batched
    matmul, so no TF32 path on the card)."""
    z = (block_inverse * residual[:, None, :]).sum(dim=-1)
    return torch.where(model.bc_mask, 0.0, z)
