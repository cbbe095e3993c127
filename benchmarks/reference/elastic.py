"""Linear elasticity element by element, from the element equations.

Small-strain isotropic elasticity, sigma = lam tr(eps) I + 2 mu eps.  The
hex8 is the trilinear brick integrated with 2 x 2 x 2 Gauss points; the
tet4 is the constant-strain tetrahedron.  The stiffness product K x is
summed element by element over blocks of cells: gather the element's
nodal values, form the strain at each quadrature point, the stress, and
scatter B^T sigma w detJ back to the nodes.  The mass is lumped by rows:
each element gives rho V / n to each of its n nodes.  Every function takes
its dtype from ``x`` and works on any device.

lam, mu and rho are each a Python float (one material) or a float64
tensor of one value per cell of the box, in the cell order of
``Box.cell_blocks`` and ``Box.elements`` (a tet cell's value holds for its
six tets).  A field is sliced per block of cells and taken in the dtype of
the work; a float keeps the one-material arithmetic, and a field that
holds one value everywhere gives the same numbers bit for bit.
"""

from __future__ import annotations

import math

import torch

from .mesh import HEX_CORNERS, Box

CELLS_PER_BLOCK = 1 << 19


def lame(E: float, nu: float):
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = E / (2.0 * (1.0 + nu))
    return lam, mu


def _hex_dn_dxi(device, dtype) -> torch.Tensor:
    """dN_l/dxi at the 8 Gauss points: (8 gp, 8 nodes, 3)."""
    g = 1.0 / math.sqrt(3.0)
    signs = torch.tensor([[2 * a - 1, 2 * b - 1, 2 * c - 1] for a, b, c in HEX_CORNERS],
                         dtype=dtype, device=device)  # (8, 3) corner signs
    gps = signs * g  # the Gauss points sit at the corners' directions
    out = torch.empty((8, 8, 3), dtype=dtype, device=device)
    for q in range(8):
        f = 1.0 + signs * gps[q]  # (8, 3): 1 + s_a xi_a per axis
        out[q, :, 0] = signs[:, 0] * f[:, 1] * f[:, 2] / 8.0
        out[q, :, 1] = signs[:, 1] * f[:, 0] * f[:, 2] / 8.0
        out[q, :, 2] = signs[:, 2] * f[:, 0] * f[:, 1] / 8.0
    return out


def gradients(box: Box, conn: torch.Tensor, pos: torch.Tensor):
    """Shape-function gradients and quadrature weights of a block.

    Returns (grads (B, Q, n, 3), weights (B, Q)) with weights = w detJ:
    Q = 8 Gauss points for hex8 (unit weights), Q = 1 for tet4 (the
    volume)."""
    xe = pos[conn]  # (B, n, 3)
    if box.element == "hex8":
        dn = _hex_dn_dxi(pos.device, pos.dtype)  # (Q, n, 3)
        jac = torch.einsum("qla,blc->bqac", dn, xe)  # dx_c/dxi_a
        inv = torch.linalg.inv(jac)  # dxi/dx
        grads = torch.einsum("bqca,qla->bqlc", inv, dn)
        return grads, torch.linalg.det(jac)
    edges = xe[:, 1:] - xe[:, :1]  # (B, 3, 3): rows x_m - x_0
    inv = torch.linalg.inv(edges)  # columns: gradients of N_1..N_3
    g123 = inv.transpose(1, 2)  # (B, 3 nodes, 3)
    g0 = -g123.sum(dim=1, keepdim=True)
    grads = torch.cat([g0, g123], dim=1)[:, None]  # (B, 1, 4, 3)
    vol = torch.linalg.det(edges).abs() / 6.0
    return grads, vol[:, None]


def _cells(value, c0: int, c1: int, dtype, dims: int):
    """A float as it is; a per-cell field's cells [c0, c1) in ``dtype``,
    shaped (B, 1, ...) with ``dims`` trailing axes to broadcast against."""
    if isinstance(value, torch.Tensor):
        return value[c0:c1].to(dtype).reshape(-1, *(1,) * dims)
    return value


def _blocks(box: Box, device, dtype):
    """(connectivity (B, E, n), gradients (E, Q, n, 3), weights (E, Q),
    cell range (c0, c1)) per block of B cells, E elements a cell.  Every
    cell of the box is a translate of the cell at the origin and gradients
    do not change under translation, so the geometry is worked out once, in
    float64 from that cell's corner positions, and rounded to ``dtype``."""
    pos = box.positions(device, torch.float64)
    grads, weights = gradients(box, box.elements(0, 1, device), pos)
    grads, weights = grads.to(dtype), weights.to(dtype)
    per_cell = 1 if box.element == "hex8" else 6
    for c0, c1 in box.cell_blocks(CELLS_PER_BLOCK):
        conn = box.elements(c0, c1, device).reshape(c1 - c0, per_cell, -1)
        yield conn, grads, weights, (c0, c1)


def stiffness_apply(box: Box, lam: float | torch.Tensor,
                    mu: float | torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K x for nodal rows ``x`` (N, 3), no boundary conditions."""
    out = torch.zeros_like(x)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    for conn, grads, weights, (c0, c1) in _blocks(box, x.device, x.dtype):
        lam_b, mu_b = (_cells(v, c0, c1, x.dtype, 4) for v in (lam, mu))
        ue = x[conn]  # (B, E, n, 3)
        g = torch.einsum("eqla,belc->beqac", grads, ue)  # du_c/dx_a
        trace = torch.diagonal(g, dim1=3, dim2=4).sum(-1)
        sigma = lam_b * trace[..., None, None] * eye + mu_b * (g + g.transpose(3, 4))
        f = torch.einsum("eqla,beqac,eq->belc", grads, sigma, weights)
        out.index_add_(0, conn.reshape(-1), f.reshape(-1, 3))
    return out


def stiffness_diagonal(box: Box, lam: float | torch.Tensor,
                       mu: float | torch.Tensor, device, dtype) -> torch.Tensor:
    """The diagonal of K as (N, 3)."""
    out = torch.zeros((box.node_count, 3), dtype=dtype, device=device)
    for conn, grads, weights, (c0, c1) in _blocks(box, device, dtype):
        lam_b, mu_b = (_cells(v, c0, c1, dtype, 4) for v in (lam, mu))
        sq = grads * grads  # (E, Q, n, 3)
        d = (lam_b + mu_b) * sq + mu_b * sq.sum(-1, keepdim=True)
        # per cell (B, E, Q, n, 3) as B E elements of their own, so that the
        # sum over Q is the one-material einsum's, row for row
        d = d.reshape(-1, *sq.shape[1:])
        d = torch.einsum("eqlc,eq->elc", d, weights.repeat(len(d) // len(weights), 1))
        d = d.reshape(-1, *conn.shape[1:], 3).expand(conn.shape[0], -1, -1, -1)
        out.index_add_(0, conn.reshape(-1), d.reshape(-1, 3))
    return out


def lumped_mass(box: Box, rho: float | torch.Tensor, device,
                dtype=torch.float64) -> torch.Tensor:
    """(N,) row-sum lumped mass: each node takes rho_c V_c / n of every
    element c around it."""
    out = torch.zeros(box.node_count, dtype=dtype, device=device)
    n = box.nodes_per_element
    for conn, _grads, weights, (c0, c1) in _blocks(box, device, dtype):
        share = _cells(rho, c0, c1, dtype, 1) * weights.sum(1) / n  # (E,) or (B, E)
        share = share.reshape(-1, conn.shape[1], 1).expand(conn.shape[0], -1, n)
        out.index_add_(0, conn.reshape(-1), share.reshape(-1))
    return out


def strain_rows(box: Box, lam: float | torch.Tensor, mu: float | torch.Tensor,
                u: torch.Tensor):
    """Per quadrature row of every element of a block of cells: Voigt
    strain (xx, yy, zz, xy, yz, xz; engineering shears) and stress, (B, E,
    Q, 6) each, with the block's connectivity (B, E, n) and the row
    weights (E, Q)."""
    for conn, grads, weights, (c0, c1) in _blocks(box, u.device, u.dtype):
        lam_b, mu_b = (_cells(v, c0, c1, u.dtype, 3) for v in (lam, mu))
        g = torch.einsum("eqla,belc->beqac", grads, u[conn])
        eps = torch.stack([
            g[..., 0, 0], g[..., 1, 1], g[..., 2, 2],
            g[..., 0, 1] + g[..., 1, 0], g[..., 1, 2] + g[..., 2, 1],
            g[..., 0, 2] + g[..., 2, 0]], dim=-1)
        tr = eps[..., :3].sum(-1, keepdim=True)
        sig = torch.cat([lam_b * tr + 2.0 * mu_b * eps[..., :3],
                         mu_b * eps[..., 3:]], -1)
        yield conn, eps, sig, weights
