"""The material layout of ``hetero-cantilever-255``: the scenario's
``box_regions`` place its materials, worked out again here.

A region is a box of fractions of the box's extent, ``lo`` to ``hi`` per
axis.  A cell belongs to the first region that holds its centre, (i +
0.5) / n on each axis of n cells in float64 with lo <= it < hi, and to
``SOLID`` where none does; ``assignments`` bind each group to a
material (a later assignment of a group wins).  lam and mu come from E
and nu by the reference's own ``elastic.lame``.
"""

from __future__ import annotations

import torch

from benchmarks.reference.elastic import lame


def cell_fields(box, scenario, device):
    regions = scenario.get("box_regions", [])
    c = torch.arange(box.cell_count, device=device)
    index = (c // (box.ny * box.nz), (c // box.nz) % box.ny, c % box.nz)
    centres = [(i.to(torch.float64) + 0.5) / n
               for i, n in zip(index, (box.nx, box.ny, box.nz))]
    group = torch.full((box.cell_count,), len(regions), device=device)  # SOLID
    for r in reversed(range(len(regions))):  # the first region wins
        inside = torch.ones(box.cell_count, dtype=torch.bool, device=device)
        for f, lo, hi in zip(centres, regions[r]["lo"], regions[r]["hi"]):
            inside &= (f >= float(lo)) & (f < float(hi))
        group[inside] = r
    names = [r["group"] for r in regions] + ["SOLID"]
    bound = {a["group"]: a["material"] for a in scenario["assignments"]}
    materials = {m["name"]: m for m in scenario["materials"]}
    fields = [torch.empty(box.cell_count, dtype=torch.float64, device=device)
              for _ in range(3)]
    for g, name in enumerate(names):
        cells = group == g
        if not bool(cells.any()):
            continue
        mat = materials[bound[name]]
        lam, mu = lame(float(mat["E"]), float(mat["nu"]))
        for field, value in zip(fields, (lam, mu, float(mat["rho"]))):
            field[cells] = value
    return tuple(fields)
