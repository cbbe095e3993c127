"""Synthetic scenarios for benchmarks, smoke runs and tests.

Port of :mod:`civiwave_tpu.utils.synthetic`, cut to ``cantilever_config``.
The structured route builds its grid from the ``synthetic://box/nx,ny,nz``
mesh path directly, so the host-side ``box_mesh`` waits for the
general-path port (ROADMAP A6).
"""

from __future__ import annotations

from typing import Dict

from ..config.loader import parse_config_node
from ..config.schema import Config


def cantilever_config(
    tol_runtime: float = 1.0e-6,
    tol_pause: float = 1.0e-8,
    max_iters: int = 400,
    dt: float = 1.0e-3,
    adaptive: bool = False,
    traction: float = -1.0e6,
    **extra: Dict,
) -> Config:
    """Steel cantilever scenario matching the synthetic box's group names
    (FIXED = x0 plane, LOAD_FACE = x1 plane, SOLID = every cell).  Pass
    e.g. ``mesh={"path": "synthetic://box/255,255,255"}`` to size it."""
    node = {
        "mesh": {"path": "synthetic://box"},
        "materials": [
            {"name": "steel", "E": 2.0e11, "nu": 0.3, "rho": 7800.0}
        ],
        "assignments": [{"group": "SOLID", "material": "steel"}],
        "damping": {"xi": 0.02, "w1": 10.0, "w2": 100.0},
        "time": {
            "dt": dt,
            "adaptive": adaptive,
            "min_dt": dt * 0.5,
            "max_dt": dt * 2.0,
        },
        "solver": {
            "type": "pcg",
            "preconditioner": "block_jacobi",
            "tol_runtime": tol_runtime,
            "tol_pause": tol_pause,
            "max_iters": max_iters,
        },
        "precision": {"vectors": "fp32", "reductions": "fp64"},
        "loads": {
            "gravity": [0.0, 0.0, 0.0],
            "tractions": [{"group": "LOAD_FACE", "value": [0.0, 0.0, traction]}],
        },
        "dirichlet": {"fixes": [{"group": "FIXED", "dof": ["x", "y", "z"]}]},
        "output": {"vtu_stride": 1, "probes": []},
    }
    node.update(extra)
    return parse_config_node(node)
