"""Derived fields at nodes: strain, stress and von Mises.

A node's strain and stress are the averages over the quadrature rows of
the elements around it, weighted by each row's w detJ (a tet's volume);
von Mises is taken of the averaged stress.  Voigt order xx, yy, zz, xy,
yz, xz with engineering shears.
"""

from __future__ import annotations

import torch

from . import elastic
from .newmark import System


def von_mises(s: torch.Tensor) -> torch.Tensor:
    normal = ((s[..., 0] - s[..., 1]) ** 2 + (s[..., 1] - s[..., 2]) ** 2
              + (s[..., 2] - s[..., 0]) ** 2)
    shear = (s[..., 3:] ** 2).sum(-1)
    return torch.sqrt(torch.clamp(0.5 * normal + 3.0 * shear, min=0.0))


def node_fields(system: System, u: torch.Tensor, nodes) -> torch.Tensor:
    """(len(nodes), 13): strain (6), stress (6) and von Mises at ``nodes``,
    from nodal displacement rows ``u``, in u's dtype."""
    n = system.box.node_count
    acc = torch.zeros((n, 12), dtype=u.dtype, device=u.device)
    weight = torch.zeros(n, dtype=u.dtype, device=u.device)
    for conn, eps, sig, w in elastic.strain_rows(system.box, system.lam, system.mu, u):
        # an element's weighted rows go to every one of its nodes
        rows = (torch.cat([eps, sig], -1) * w[..., None]).sum(2)  # (B, E, 12)
        nl = conn.shape[2]
        flat = conn.reshape(-1)
        acc.index_add_(0, flat, rows[:, :, None, :].expand(-1, -1, nl, -1).reshape(-1, 12))
        per = w.sum(1)[None, :, None].expand(conn.shape[0], -1, nl)
        weight.index_add_(0, flat, per.reshape(-1))
    idx = torch.as_tensor(nodes, device=u.device)
    avg = acc[idx] / weight[idx, None]
    return torch.cat([avg, von_mises(avg[:, 6:])[:, None]], -1)
