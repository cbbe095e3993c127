"""Matrix-free effective-stiffness operator K_eff * x of the general path.

Port of :mod:`civiwave_tpu.ops.apply_keff`, without the TPU's banded-window
and offset-pattern (oct) gather forms (ROADMAP "Do not port").  The
isotropic element product is evaluated in tensor form,

    G   = sum_l grad_l (x) u_l          (displacement gradient)
    S   = lam * tr(G) * I + mu * (G + G^T)      (Cauchy stress)
    f_l = V * scale * sum_a grad_la * S_ab

which equals f = B^T D B u for the isotropic Voigt D.  Two phases, both
gather-based (no scatter, no float atomics — the reference engine's
assembly contract, docs/spec.md:35):

1. per-element forces: each element gathers its corner rows of the
   sanitized x and writes its local force rows — kernel K7
   (``ops/cuda/element_forces.py``, ``csrc/element_forces.cu``) on the card,
   :func:`tet_forces` / :func:`hex_forces` here as its plain version;
2. assembly: each node sums its incident force rows over the dual CSR, adds
   the mass term and writes identity rows on constrained axes — kernel G1
   (``ops/cuda/assemble_csr.py``, ``csrc/assemble_csr.cu``) on the card,
   :func:`assemble` plus those two lines here.

Semantics (pcg.cpp:530-686): constrained input components read as zero;
element forces scale by ``volume * stiffness_scale``; ``+ mass_factor *
lumped_mass * x_sanitized`` adds the mass term; constrained rows are
identity (output = raw input).  A model with absorbing dashpots and a
``damp_factor`` (set by the stepper per step) adds ``damp_factor * C xs``
on free rows (:func:`add_dashpot_term`, the reference's XLA term after its
assembly): torch ops on either device, after G1 on the card.

:func:`apply_keff` dispatches by device: a CPU tensor takes the plain
versions, a CUDA tensor launches K7 and G1 or raises.
"""

from __future__ import annotations

import torch

from ..mesh.pack import PackedModel
from .cuda import assemble_csr, element_forces


def sanitize(model: PackedModel, x: torch.Tensor) -> torch.Tensor:
    """Zero constrained components (pcg.cpp:535-546), +0.0 by select."""
    return torch.where(model.bc_mask, 0.0, x)


def _stream_math(
    u_streams, grad_stream, vol_stream, lam, mu, n_local: int, n_gp: int
):
    """Scalar-component force math: every quantity an (E,)-shaped stream
    combined by unrolled sums over gp/l/axis, in the reference's order.
    Returns the (nl*3, E) force stream stack."""
    u = [[u_streams[l * 3 + b] for b in range(3)] for l in range(n_local)]
    f = [[None] * 3 for _ in range(n_local)]
    for g in range(n_gp):
        gr = [
            [grad_stream(g, l, a) for a in range(3)] for l in range(n_local)
        ]
        vs = vol_stream(g)
        # G_ab = sum_l dN_la u_lb  (displacement gradient)
        G = [
            [
                sum(gr[l][a] * u[l][b] for l in range(n_local))
                for b in range(3)
            ]
            for a in range(3)
        ]
        tr = G[0][0] + G[1][1] + G[2][2]
        # S_ab = V s (lam tr d_ab + mu (G_ab + G_ba))
        S = [
            [
                vs
                * (
                    mu * (G[a][b] + G[b][a])
                    + (lam * tr if a == b else 0.0)
                )
                for b in range(3)
            ]
            for a in range(3)
        ]
        for l in range(n_local):
            for b in range(3):
                contrib = sum(gr[l][a] * S[a][b] for a in range(3))
                f[l][b] = contrib if f[l][b] is None else f[l][b] + contrib
    return torch.stack([f[l][b] for l in range(n_local) for b in range(3)])


def _u_streams(xs: torch.Tensor, conn: torch.Tensor) -> torch.Tensor:
    """(nl*3, E) gathered displacement component streams."""
    e_pad, n_local = conn.shape
    return xs[conn.reshape(-1).long()].reshape(e_pad, n_local * 3).T


def _widened(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """An f32 table as the vectors' dtype: f64 vectors scale by f64
    products (``V * ss``, ``mf * m``), as the reference's f32 tables times
    its f64 scalars; f32 vectors keep the f32 products."""
    return table if table.dtype == x.dtype else table.to(x.dtype)


def tet_forces(model: PackedModel, x_sanitized: torch.Tensor, stiffness_scale):
    """(T* * 4, 3) local node force rows for the tet block."""
    vs = _widened(model.vol_tet, x_sanitized) * float(stiffness_scale)
    f = _stream_math(
        _u_streams(x_sanitized, model.conn_tet),
        lambda g, l, a: model.grads_tet[l, a],
        lambda g: vs,
        model.lam_tet,
        model.mu_tet,
        4,
        1,
    )
    return f.T.reshape(-1, 3)


def hex_forces(model: PackedModel, x_sanitized: torch.Tensor, stiffness_scale):
    """(H* * 8, 3) gp-reduced local node force rows for the hex block."""
    volss = _widened(model.vol_hex, x_sanitized) * float(stiffness_scale)
    f = _stream_math(
        _u_streams(x_sanitized, model.conn_hex),
        lambda g, l, a: model.grads_hex[g, l, a],
        lambda g: volss[g],
        model.lam_hex,
        model.mu_hex,
        8,
        8,
    )
    return f.T.reshape(-1, 3)


def element_force_rows(
    model: PackedModel, x_sanitized: torch.Tensor, stiffness_scale
) -> torch.Tensor:
    """(R, 3) concatenated force rows from both element blocks."""
    parts = []
    if model.padded_tet_count:
        parts.append(tet_forces(model, x_sanitized, stiffness_scale))
    if model.padded_hex_count:
        parts.append(hex_forces(model, x_sanitized, stiffness_scale))
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts, dim=0)


def assemble(model: PackedModel, rows: torch.Tensor) -> torch.Tensor:
    """Per-node gather-sum over the dual CSR (ke_gather_node analogue), the
    slots summed in order."""
    idx = model.csr_idx.long()
    out = None
    for d in range(model.csr_degree):
        term = rows[idx[:, d]] * model.csr_weight[:, d, None]
        out = term if out is None else out + term
    return out


def finish_keff(model: PackedModel, assembled, x, mass_factor):
    """Mass term and identity rows: ``bc ? x : assembled + mf m xs``."""
    xs = sanitize(model, x)
    mm = float(mass_factor) * _widened(model.lumped_mass, x)
    out = assembled + mm[:, None] * xs
    return torch.where(model.bc_mask, x, out)


def add_dashpot_term(model: PackedModel, out, x):
    """``out + where(bc, 0, damp_factor * C xs)``: the Lysmer-Kuhlemeyer
    dashpots enter K_eff as + a1 C, masked on both sides (xs is sanitized)
    so the operator stays symmetric for CG; ``out`` unchanged without
    dashpots or outside a step (``damp_factor`` None)."""
    if not model.has_damping or model.damp_factor is None:
        return out
    from ..physics.absorbing import sym_apply

    add_dashpot_term.calls += 1
    term = model.damp_factor * sym_apply(model.damp_blocks, sanitize(model, x))
    return out + torch.where(model.bc_mask, 0.0, term)


add_dashpot_term.calls = 0  # applications of the term (torch ops, no kernel)


def elastic_keff_plain(model: PackedModel, x, stiffness_scale, mass_factor):
    """Plain PyTorch ``bc ? x : K x + mf m xs``: the operator without the
    dashpot term."""
    rows = element_force_rows(model, sanitize(model, x), stiffness_scale)
    return finish_keff(model, assemble(model, rows), x, mass_factor)


def apply_keff_plain(model: PackedModel, x, stiffness_scale, mass_factor):
    """Plain PyTorch K_eff * x with Dirichlet identity rows."""
    out = elastic_keff_plain(model, x, stiffness_scale, mass_factor)
    return add_dashpot_term(model, out, x)


def elastic_keff(model: PackedModel, x, stiffness_scale, mass_factor):
    """The operator without the dashpot term: the plain version for a CPU
    tensor, K7 (each block present) then G1 for a CUDA one."""
    if x.device.type == "cpu":
        return elastic_keff_plain(model, x, stiffness_scale, mass_factor)
    rows = element_forces.element_force_rows(model, x, stiffness_scale)
    return assemble_csr.assemble_keff(model, rows, x, mass_factor)


def apply_keff(
    model: PackedModel, x: torch.Tensor, stiffness_scale, mass_factor
) -> torch.Tensor:
    """K_eff * x with Dirichlet identity rows (pcg.cpp:505-694).

    x: (N*, 3).  ``stiffness_scale`` / ``mass_factor`` are host scalars
    (they change with adaptive dt, newmark_stepper.cpp:1322-1326); the
    Rayleigh-beta RHS term passes ``mass_factor = 0``.  A CPU tensor takes
    the plain version; a CUDA f32 or f64 tensor launches K7 (tet and/or
    hex) and G1 (their f64 instances for f64, ``precision.vectors: fp64``),
    or raises; the dashpot term follows either.
    """
    out = elastic_keff(model, x, stiffness_scale, mass_factor)
    return add_dashpot_term(model, out, x)
