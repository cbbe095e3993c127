"""Solver state container.

Port of :mod:`civiwave_tpu.mesh.pack`, cut to ``SimState`` and
``zero_state``.  The general path's ``PackedModel`` (dual-CSR gather
assembly) waits for ROADMAP A6.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SimState:
    """Evolving kinematic state + PCG warm-start vector, each in the
    model's vector layout ((3, X, Y, Z) f32 on the structured route)."""

    displacement: torch.Tensor
    velocity: torch.Tensor
    acceleration: torch.Tensor
    warm_x: torch.Tensor  # previous PCG solution (or correction, "delta")


def zero_state(model) -> SimState:
    """Zero kinematic state in the model's vector layout."""
    return model.zero_state()
