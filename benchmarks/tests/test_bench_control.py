"""The control has to come out as not correct: the reference put in the
program's place and computed in bfloat16, the precision below the
configurations' float32, run through the harness at the cells' small
sizes on the CPU, as ``benchmarks/control.py`` runs it at the cells' own
sizes on the card.

    python -m pytest -q benchmarks/tests
"""

from __future__ import annotations

import pytest
import torch

from benchmarks.tests.support import CELLS, OUTPUT_CELL, run_small


@pytest.mark.parametrize("cell", CELLS + [OUTPUT_CELL])
def test_control_is_not_correct(cell):
    program = run_small(cell, 31)
    control = run_small(cell, 31, control_dtype=torch.bfloat16)
    assert program["correct"], program["check"]
    assert not control["correct"]
    # the frames of the window, whose load is never zero, fail by a margin
    residual = control["check"]["residual.w0"]
    assert residual["value"] > 3 * residual["limit"], residual
