"""A run of the harness with the timed path broken underneath comes out
not correct, once for each fault a cell of one card can have: a frame
that returns its state unchanged, half of the nodes left out of the
update, one answer altered where it is produced, and (with output) a
probe row's derived field altered.  CPU, the cells' small sizes.

    python -m pytest -q benchmarks/tests
"""

from __future__ import annotations

import pytest
import torch

from civiwave_tpu_torch.mesh.pack import SimState
from civiwave_tpu_torch.post import output as output_mod
from civiwave_tpu_torch.solver import stepper as stepper_mod
from benchmarks.tests.support import CELLS, OUTPUT_CELL, run_small


def _fields(state):
    return (state.displacement, state.velocity, state.acceleration, state.warm_x)


def _unchanged(state, out):
    return state


def _half_left_out(state, out):
    fields = []
    for old, new in zip(_fields(state), _fields(out.state)):
        new = new.clone()
        half = new.numel() // 2
        new.view(-1)[:half] = old.reshape(-1)[:half]
        fields.append(new)
    return SimState(*fields)


def _one_answer_altered(state, out, beta=0.25, gamma=0.5):
    """u of the node that moved most, 1 % of max|u| off, with v and a
    updated from it as the frame would (only the residual can see it)."""
    u, v, a, w = _fields(out.state)
    dt = _one_answer_altered.dt
    i = int(u.abs().reshape(-1).argmax())
    e = torch.zeros_like(u).reshape(-1)
    e[i] = 0.01 * float(u.abs().max())
    e = e.reshape(u.shape)
    return SimState(u + e, v + gamma / (beta * dt) * e, a + e / (beta * dt * dt), w)


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
          "one_answer_altered": _one_answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    real = stepper_mod.newmark_step

    def broken(model, state, external_force, dt, *args, **kwargs):
        out = real(model, state, external_force, dt, *args, **kwargs)
        _one_answer_altered.dt = dt
        return stepper_mod.StepOut(state=FAULTS[fault](state, out), pcg=out.pcg)

    monkeypatch.setattr(stepper_mod, "newmark_step", broken)
    result = run_small(cell, 17)
    assert not result["correct"], result["check"]


def test_probe_row_altered_is_not_correct(monkeypatch):
    real = output_mod.compute_derived_fields

    def broken(*args, **kwargs):
        fields = real(*args, **kwargs)
        fields.node_stress = fields.node_stress * 1.01
        return fields

    monkeypatch.setattr(output_mod, "compute_derived_fields", broken)
    result = run_small(OUTPUT_CELL, 17)
    assert not result["correct"], result["check"]
    assert result["check"]["probe_gap.w0"]["value"] > result["check"]["probe_gap.w0"]["limit"]
