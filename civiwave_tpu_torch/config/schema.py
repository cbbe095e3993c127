"""Scenario configuration model.

Mirrors the user-facing YAML schema of the reference engine
(the reference engine's include/cwf/config/config.hpp:97-237).  The YAML document is
the single source of scenario truth — materials, assignments, Rayleigh
damping, time stepping, solver knobs, precision, curves, loads, Dirichlet
fixes, and output controls.  The schema is kept byte-compatible so scenario
files written for the reference load unchanged here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class Material:
    """Isotropic linear-elastic material (config.hpp:97-103)."""

    name: str
    youngs_modulus: float  # E [Pa], > 0
    poisson_ratio: float  # nu, (-0.999, 0.5)
    density: float  # rho [kg/m^3], > 0


@dataclass(frozen=True)
class Assignment:
    """Physical group -> material mapping (config.hpp:108-112)."""

    group: str
    material: str


@dataclass(frozen=True)
class Damping:
    """Rayleigh damping inputs (xi, w1, w2) (config.hpp:119-124)."""

    xi: float
    w1: float
    w2: float


@dataclass(frozen=True)
class TimeSettings:
    """Time stepping defaults + adaptive bounds (config.hpp:129-135)."""

    initial_dt: float
    adaptive: bool
    min_dt: float = 0.0
    max_dt: float = 0.0


@dataclass(frozen=True)
class SolverSettings:
    """PCG solver knobs (config.hpp:140-147)."""

    type: str
    preconditioner: str
    runtime_tolerance: float
    pause_tolerance: float
    max_iterations: int
    # optional extensions beyond the reference schema (additive, defaulted):
    # warm-start seed policy (ADR-17): 'predictor' (default, seeds PCG from
    # the Newmark predictor) or 'solution' (reference parity: previous
    # solve's solution, newmark_stepper.cpp:1120-1133)
    warm_start_policy: str = "predictor"
    # PCG reduction layout: 'auto' (default — dispatch picks per model),
    # 'classic' (3 dependent dots/iteration, pcg.cpp:830-915), 'fused'
    # (Chronopoulos-Gear single fused reduction/iteration — one all-reduce
    # on multi-chip meshes) or 'pipelined' (Ghysels-Vanroose).  Default
    # matches the YAML loader (loader.py) so direct-construction users get
    # the same solver as YAML users.
    variant: str = "auto"
    # pipelined-variant residual-replacement period (ADR-25): every
    # `replace_every` iterations the recurred (u, w) are recomputed from
    # the recurred residual with one extra pc+matvec pass.  0 disables —
    # safe at production tolerances (2e-4), where the f32 drift floor
    # (~5e-5 relative) never surfaces.  Ignored by the other variants.
    replace_every: int = 10


@dataclass(frozen=True)
class PrecisionSettings:
    """FP32 vectors / FP64 reductions contract (config.hpp:152-156)."""

    vector_precision: str
    reduction_precision: str


@dataclass(frozen=True)
class Curve:
    """Piecewise-linear (time, value) curve (config.hpp:161-164)."""

    points: Tuple[Tuple[float, float], ...]


@dataclass(frozen=True)
class SurfaceTraction:
    """Surface traction on a physical group (config.hpp:169-174)."""

    group: str
    value: Tuple[float, float, float]
    scale_curve: str = ""


@dataclass(frozen=True)
class PointLoad:
    """Concentrated per-node load on a node group (config.hpp:185-190)."""

    group: str
    value: Tuple[float, float, float]
    scale_curve: str = ""


@dataclass(frozen=True)
class Loads:
    """Aggregated loads: gravity + tractions + points (config.hpp:195-200)."""

    gravity: Tuple[float, float, float]
    tractions: Tuple[SurfaceTraction, ...] = ()
    points: Tuple[PointLoad, ...] = ()


@dataclass(frozen=True)
class DirichletFix:
    """Per-axis Dirichlet constraint with optional targets (config.hpp:205-210)."""

    group: str
    constrain_axis: Tuple[bool, bool, bool]
    value: Tuple[Optional[float], Optional[float], Optional[float]] = (None, None, None)


@dataclass(frozen=True)
class OutputSettings:
    """VTU cadence + probe node indices (config.hpp:215-219)."""

    vtu_stride: int
    probes: Tuple[int, ...] = ()


@dataclass(frozen=True)
class BoxRegion:
    """A named box of cells of a ``synthetic://box`` mesh, as fractions of
    the box's extent per axis (``0 <= lo < hi <= 1``): a cell belongs to
    the first listed region that holds its centre, else to ``SOLID``, and
    ``assignments`` bind the name as they bind a Gmsh physical volume."""

    group: str
    lo: Tuple[float, float, float]
    hi: Tuple[float, float, float]


@dataclass(frozen=True)
class Config:
    """Full scenario bundle (config.hpp:224-237).

    ``absorbing`` extends the reference schema (which has no absorbing
    boundaries anywhere): surface-group names whose faces receive
    Lysmer-Kuhlemeyer viscous dashpots (physics/absorbing.py) — the
    truncated-domain machinery BASELINE.json's seismic-basin config
    needs.  ``box_regions`` extends it too: named boxes of cells of a
    ``synthetic://box`` mesh (:class:`BoxRegion`), the box's volume groups
    besides ``SOLID``.  Both optional; omitted = byte-compatible reference
    behavior."""

    mesh_path: str
    materials: Tuple[Material, ...]
    assignments: Tuple[Assignment, ...]
    damping: Damping
    time: TimeSettings
    solver: SolverSettings
    precision: PrecisionSettings
    loads: Loads
    curves: Dict[str, Curve] = field(default_factory=dict)
    dirichlet: Tuple[DirichletFix, ...] = ()
    output: OutputSettings = OutputSettings(vtu_stride=1)
    absorbing: Tuple[str, ...] = ()
    box_regions: Tuple[BoxRegion, ...] = ()
