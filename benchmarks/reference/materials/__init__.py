"""A configuration's own material layout, found by the configuration's name.

``benchmarks/reference/materials/<config>.py``, where it exists, exports

    cell_fields(box, scenario, device) -> (lam, mu, rho)

three float64 tensors of one value per cell of the box, in the cell order
of ``Box.cell_blocks`` (a tet cell's value holds for its six tets), worked
out by the reference itself from the scenario node (its ``materials`` and
whatever the configuration states of where each one lies).  A
configuration without such a file has one material; a scenario with more
and no file is refused (``newmark.material_fields``).  Like the rest of
the reference, these modules import neither JAX, the JAX package nor the
program.
"""

from __future__ import annotations

from pathlib import Path

from benchmarks.harness.cells import load_file_module

DIR = Path(__file__).resolve().parent


def path(config: str) -> Path:
    return DIR / f"{config}.py"


def layout(config: str | None):
    """The ``cell_fields`` of ``config``'s layout file, or None where the
    configuration has none."""
    if config is None or not path(config).is_file():
        return None
    return load_file_module("bench_materials_", path(config)).cell_fields
