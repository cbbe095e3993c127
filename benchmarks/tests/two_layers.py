"""A material layout for the tests, written as a configuration's layout file
under ``benchmarks/reference/materials`` would be: the scenario's first
material in the cells below the box's middle x plane, its second in the
rest, two layers across the x axis.  The tests copy it there under a test
configuration's name (into a directory of their own)."""

from __future__ import annotations

import torch

from benchmarks.reference.elastic import lame


def cell_fields(box, scenario, device):
    low, high = scenario["materials"]
    i = torch.arange(box.cell_count, device=device) // (box.ny * box.nz)
    first = i < box.nx // 2
    fields = []
    for a, b in zip(_constants(low), _constants(high)):
        field = torch.full((box.cell_count,), b, dtype=torch.float64, device=device)
        field[first] = a
        fields.append(field)
    return tuple(fields)


def _constants(mat):
    lam, mu = lame(float(mat["E"]), float(mat["nu"]))
    return lam, mu, float(mat["rho"])
