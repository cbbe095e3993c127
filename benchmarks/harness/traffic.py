"""The one generator of load histories: a traffic file's parameters and a
seed give the time step, the warm-up, the load curve and the output.

Every load is periodic, so the solver's work per frame is stationary: a
faster program reaches later frames of the same kind of load.  The seed
permutes a fixed set of amplitude factors (evenly spaced over the file's
``amplitude`` range, one per period or pulse) and draws the phase, so two
seeds give the same sizes in another order.  The curve is sampled once
per time step over the file's ``frames``.

Load kinds:

* ``sine``: A_p sin(2 pi (k + o) / P) at frame k, with P =
  ``period_frames`` (even), the phase offset o in [0, P) and A_p the
  factor of period p = (k + o) // P;
* ``pulses``: half-sines ``width_frames`` frames wide every
  ``every_frames`` frames, each with its own factor.

Zero crossings are sampled as exact zeros: a first frame from rest under
a load of 1e-16 of its scale is numerical noise, not a load.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Traffic:
    dt: float
    frames: int  # frames the curve covers
    warmup_frames: int
    curve: list  # [(t, value)] sampled every dt
    output: dict | None = None  # probes (as fractions of the box) and stride
    output_warmup_frames: int = 0
    rng: np.random.Generator = field(repr=False, default=None)


def seed_sequence(seed: int) -> np.random.SeedSequence:
    """Any whole number, negative or beyond 64 bits, as numpy entropy."""
    return np.random.SeedSequence(int(seed) % (1 << 64))


def _factors(rng, lo: float, hi: float, count: int) -> np.ndarray:
    return rng.permutation(np.linspace(lo, hi, count))


def load_values(spec: dict, frames: int, rng) -> np.ndarray:
    """The curve's value at frames 0..frames (inclusive)."""
    k = np.arange(frames + 1)
    lo, hi = spec["amplitude"]
    if spec["kind"] == "sine":
        period = int(spec["period_frames"])
        offset = int(rng.integers(period))
        phase = k + offset
        amp = _factors(rng, lo, hi, phase[-1] // period + 1)[phase // period]
        wave = np.sin(2.0 * np.pi * phase / period)
        # a zero crossing is zero (sin(pi) is 1.2e-16 in floating point)
        return amp * np.where(phase % (period // 2) == 0, 0.0, wave)
    if spec["kind"] == "pulses":
        every, width = int(spec["every_frames"]), int(spec["width_frames"])
        amp = _factors(rng, lo, hi, frames // every + 1)[k // every]
        within = k % every
        inside = (within > 0) & (within < width)
        return np.where(inside, amp * np.sin(np.pi * within / width), 0.0)
    raise ValueError(f"unknown load kind {spec['kind']!r}")


def generate(spec: dict, seed: int) -> Traffic:
    rng = np.random.default_rng(seed_sequence(seed))
    dt = float(spec["dt"])
    frames = int(spec["frames"])
    values = load_values(spec["load"], frames, rng)
    curve = [(k * dt, float(v)) for k, v in enumerate(values)]
    return Traffic(
        dt=dt, frames=frames, warmup_frames=int(spec["warmup_frames"]),
        curve=curve, output=spec.get("output"),
        output_warmup_frames=int(spec.get("output_warmup_frames", 0)), rng=rng)
