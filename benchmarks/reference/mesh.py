"""The box meshes the cells run, built again from their definition.

A box of ``nx * ny * nz`` cubic cells of side ``spacing`` on
``[0, nx h] x [0, ny h] x [0, nz h]``.  Nodes are numbered x-major,
``id(i, j, k) = (i * (ny + 1) + j) * (nz + 1) + k``.  A cell is a hex8
(Gmsh corner order) or its split into six tet4 around the main diagonal
from corner 0 to corner 6.  The x = 0 plane is fixed; the traction acts on
the x = nx plane.  Connectivity is made per block of cells, on the device,
so that no table of the whole mesh is ever held.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# Gmsh hex8 corner order, as (di, dj, dk) offsets of the cell's low corner
HEX_CORNERS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
               (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
# six tets sharing the diagonal 0-6, as hex corner indices
TET_SPLIT = ((0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
             (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6))


@dataclass(frozen=True)
class Box:
    nx: int
    ny: int
    nz: int
    element: str  # "hex8" or "tet4"
    spacing: float = 1.0

    @property
    def node_count(self) -> int:
        return (self.nx + 1) * (self.ny + 1) * (self.nz + 1)

    @property
    def cell_count(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def nodes_per_element(self) -> int:
        return 8 if self.element == "hex8" else 4

    def node_id(self, i, j, k):
        return (i * (self.ny + 1) + j) * (self.nz + 1) + k

    def node_index(self, device) -> tuple:
        """(i, j, k) integer coordinates of every node, in id order."""
        ids = torch.arange(self.node_count, device=device)
        zs, ys = self.nz + 1, self.ny + 1
        return ids // (ys * zs), (ids // zs) % ys, ids % zs

    def positions(self, device, dtype=torch.float64) -> torch.Tensor:
        i, j, k = self.node_index(device)
        return torch.stack([i, j, k], dim=1).to(dtype) * self.spacing

    def fixed_mask(self, device) -> torch.Tensor:
        """(N, 3) bool: every axis of the x = 0 plane."""
        i, _, _ = self.node_index(device)
        return (i == 0)[:, None].expand(-1, 3).clone()

    def cell_blocks(self, cells_per_block: int):
        for c0 in range(0, self.cell_count, cells_per_block):
            yield c0, min(self.cell_count, c0 + cells_per_block)

    def elements(self, c0: int, c1: int, device) -> torch.Tensor:
        """Connectivity of cells [c0, c1): (B, 8) hexes or (6B, 4) tets."""
        c = torch.arange(c0, c1, device=device)
        i, j, k = c // (self.ny * self.nz), (c // self.nz) % self.ny, c % self.nz
        corners = torch.stack(
            [self.node_id(i + a, j + b, k + d) for a, b, d in HEX_CORNERS], dim=1)
        if self.element == "hex8":
            return corners
        split = torch.tensor(TET_SPLIT, device=device)
        return corners[:, split].reshape(-1, 4)

    def face_weights(self, device, dtype=torch.float64) -> torch.Tensor:
        """(N,) share of the x = nx face's area at each node: each face
        quad gives a quarter of its area to each of its corners."""
        i, j, k = self.node_index(device)
        h2 = self.spacing * self.spacing
        wj = torch.where((j == 0) | (j == self.ny), 0.5, 1.0)
        wk = torch.where((k == 0) | (k == self.nz), 0.5, 1.0)
        return torch.where(i == self.nx, wj * wk * h2, 0.0).to(dtype)


def parse_box(path: str) -> Box:
    """``synthetic://box/nx,ny,nz[,tet|hex][,spacing]`` -> Box."""
    prefix = "synthetic://box/"
    if not path.startswith(prefix):
        raise ValueError(f"not a synthetic box: {path}")
    parts = path[len(prefix):].split(",")
    nx, ny, nz = (int(p) for p in parts[:3])
    element, spacing = "hex8", 1.0
    for p in parts[3:]:
        if p in ("tet", "hex"):
            element = "tet4" if p == "tet" else "hex8"
        else:
            spacing = float(p)
    return Box(nx, ny, nz, element, spacing)
