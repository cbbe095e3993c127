"""CSV probe logger.

Copy of :mod:`civiwave_tpu.post.probes` (host numpy), a rebuild of the
reference engine's src/post/probe_logger.cpp:59-127: one row per probe node
per frame with frame, time, node, u/v/a (9 scalars), 6 strain,
6 stress components, and von Mises — identical header and column order
(probe_logger.cpp:83-85), fixed 9-decimal formatting, header written once,
append mode, out-of-range probe raises.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..utils.errors import ProbeError
from .derived import DerivedFieldSet

_HEADER = (
    "frame,time,node,ux,uy,uz,vx,vy,vz,ax,ay,az"
    ",strain_xx,strain_yy,strain_zz,strain_xy,strain_yz,strain_xz"
    ",stress_xx,stress_yy,stress_zz,stress_xy,stress_yz,stress_xz,von_mises\n"
)


class ProbeLogger:
    """Appends probe rows to a CSV file (probe_logger.hpp:29-45)."""

    def __init__(self, path: str, probes: Sequence[int]) -> None:
        self.path = path
        self.probes = list(probes)
        self._header_written = False

    def _write_header(self) -> None:
        if self._header_written or not self.probes:
            self._header_written = True
            return
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        try:
            with open(self.path, "w", encoding="ascii") as f:
                f.write(_HEADER)
        except OSError:
            raise ProbeError(
                "failed to open probe CSV for header", [str(self.path)]
            ) from None
        self._header_written = True

    def log_frame(
        self,
        simulation_time: float,
        frame_index: int,
        displacement: np.ndarray,  # (N, 3)
        velocity: np.ndarray,
        acceleration: np.ndarray,
        derived: DerivedFieldSet,
    ) -> None:
        """Append one row per probe (probe_logger.cpp:90-124)."""
        if not self.probes:
            return
        if not self._header_written:
            self._write_header()

        node_count = displacement.shape[0]
        rows = []
        for probe in self.probes:
            if probe >= node_count:
                raise ProbeError("probe index out of range", [str(probe)])
            u, v, a = displacement[probe], velocity[probe], acceleration[probe]
            values = [
                f"{float(x):.9f}"
                for x in (
                    *u,
                    *v,
                    *a,
                    *derived.node_strain[probe],
                    *derived.node_stress[probe],
                    derived.node_von_mises[probe],
                )
            ]
            rows.append(
                f"{frame_index},{simulation_time:.9f},{probe},"
                + ",".join(values)
                + "\n"
            )
        try:
            with open(self.path, "a", encoding="ascii") as f:
                f.writelines(rows)
        except OSError:
            raise ProbeError("failed to open probe CSV", [str(self.path)]) from None

    def log_sampled(
        self,
        simulation_time: float,
        frame_index: int,
        node_count: int,
        kinematics: np.ndarray,  # (P, 3 kin, 3 comp) u/v/a rows per probe
        derived_rows,  # list of (strain6, stress6, von_mises) per probe
    ) -> None:
        """Append rows from per-probe device samples (no full-field arrays
        — the O(1) path for large structured grids); identical format to
        :meth:`log_frame`."""
        if not self.probes:
            return
        if not self._header_written:
            self._write_header()
        rows = []
        for idx, probe in enumerate(self.probes):
            if probe >= node_count:
                raise ProbeError("probe index out of range", [str(probe)])
            u, v, a = kinematics[idx]
            strain, stress, vm = derived_rows[idx]
            values = [
                f"{float(x):.9f}"
                for x in (*u, *v, *a, *strain, *stress, vm)
            ]
            rows.append(
                f"{frame_index},{simulation_time:.9f},{probe},"
                + ",".join(values)
                + "\n"
            )
        try:
            with open(self.path, "a", encoding="ascii") as f:
                f.writelines(rows)
        except OSError:
            raise ProbeError("failed to open probe CSV", [str(self.path)]) from None
