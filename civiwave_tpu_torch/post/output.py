"""Per-frame output orchestration.

Port of :mod:`civiwave_tpu.post.output` (a rebuild of the reference
engine's src/post/output_manager.cpp:35-87): every frame computes derived
fields, writes ``vtu/frame_{:05d}.vtu`` when ``frame % vtu_stride == 0``,
and appends probe rows to ``probes/probes.csv``.

Two managers share the layout: :class:`OutputManager` (the general gather
path: host mesh, preprocess and numpy derived fields) and
:class:`StructuredOutputManager` (the structured route: derived fields on
the model's device, O(1) probe sampling, whole-field transfers only on VTU
frames).  VTU frames are written on a background thread (a bounded queue)
so disk IO overlaps the next steps; everything handed to it is host numpy,
never a device tensor, and a worker's exception is raised at the next
``submit`` or ``flush``.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

from ..config.schema import OutputSettings
from ..mesh.model import Mesh
from ..mesh.preprocess import PreprocessOutputs
from .derived import DerivedFieldSet, compute_derived_fields
from .probes import ProbeLogger
from .vtu import write_vtu, write_vtu_structured


class AsyncWriter:
    """Background frame writer: a bounded queue and one worker thread, so a
    VTU dump overlaps the following steps.  A worker's exception is raised
    at the next submit/flush."""

    def __init__(self, max_pending: int = 2) -> None:
        self._queue: queue.Queue = queue.Queue(maxsize=max_pending)
        self._error = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            fn, args = self._queue.get()
            try:
                fn(*args)
            except BaseException as exc:  # raised at submit/flush
                self._error = exc
            finally:
                self._queue.task_done()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, fn, *args) -> None:
        self._raise_pending()
        self._queue.put((fn, args))

    def flush(self) -> None:
        self._queue.join()
        self._raise_pending()


def _vtu_path(root: str, frame_index: int) -> str:
    return os.path.join(root, "vtu", f"frame_{frame_index:05d}.vtu")


class OutputManager:
    """Output of the general gather path (output_manager.hpp:41): host mesh
    and preprocess, derived fields in numpy from the stepper's nodal
    views (mesh order, whatever the pack's node numbering)."""

    def __init__(
        self,
        output_root: str,
        settings: OutputSettings,
        mesh: Mesh,
        preprocess: PreprocessOutputs,
        stiffness_6x6: np.ndarray,
    ) -> None:
        self.output_root = output_root
        self.settings = settings
        self.mesh = mesh
        self.preprocess = preprocess
        self.stiffness_6x6 = np.asarray(stiffness_6x6)
        self.probe_logger = ProbeLogger(
            os.path.join(output_root, "probes", "probes.csv"), settings.probes
        )
        self._writer = AsyncWriter()

    def handle_from_stepper(
        self, simulation_time: float, frame_index: int, stepper
    ) -> None:
        """Pull the nodal views from the stepper and run the frame."""
        self.handle_frame(
            simulation_time,
            frame_index,
            stepper.displacement(),
            stepper.velocity(),
            stepper.acceleration(),
        )

    def flush(self) -> None:
        self._writer.flush()

    def handle_frame(
        self,
        simulation_time: float,
        frame_index: int,
        displacement: np.ndarray,
        velocity: np.ndarray,
        acceleration: np.ndarray,
    ) -> DerivedFieldSet:
        """Derived fields -> VTU (strided) -> probe CSV
        (output_manager.cpp:71-87)."""
        derived = compute_derived_fields(
            self.preprocess,
            self.stiffness_6x6,
            displacement,
            self.mesh.node_count,
            self.mesh.element_count,
        )
        if frame_index % max(self.settings.vtu_stride, 1) == 0:
            args = (
                _vtu_path(self.output_root, frame_index), self.mesh,
                displacement, velocity, acceleration, derived,
                simulation_time, frame_index,
            )
            self._writer.submit(write_vtu, *args)
        self.probe_logger.log_frame(
            simulation_time,
            frame_index,
            displacement,
            velocity,
            acceleration,
            derived,
        )
        return derived


class StructuredOutputManager:
    """Output of the structured route: derived fields on the model's device
    (``post/structured_fields.py``), probe rows sampled O(1) per frame,
    whole-field transfers only on VTU frames, VTU written asynchronously
    with implicit connectivity.  A shard raises NotImplementedError
    (ROADMAP A11)."""

    def __init__(
        self,
        output_root: str,
        settings: OutputSettings,
        model,
    ) -> None:
        if model.shard_group is not None:
            raise NotImplementedError(
                "output of a sharded model is not ported yet (ROADMAP A11)"
            )
        self.output_root = output_root
        self.settings = settings
        self.model = model
        self.probe_logger = ProbeLogger(
            os.path.join(output_root, "probes", "probes.csv"), settings.probes
        )
        self._writer = AsyncWriter()
        self._x0 = None  # host rest positions, fetched on the first VTU frame

    def handle_from_stepper(
        self, simulation_time: float, frame_index: int, stepper
    ) -> None:
        from .structured_fields import (
            compute_structured_derived,
            derived_to_host,
            probe_derived_host,
            probe_samples,
        )

        model = self.model
        state = stepper.state
        if frame_index % max(self.settings.vtu_stride, 1) == 0:
            derived = derived_to_host(
                model, compute_structured_derived(model, state.displacement)
            )
            u, v, a = (
                model.to_nodal(t).cpu().numpy()
                for t in (state.displacement, state.velocity,
                          state.acceleration)
            )
            if self._x0 is None:
                self._x0 = model.position0[: model.node_count].cpu().numpy()
            args = (
                _vtu_path(self.output_root, frame_index),
                model.nx, model.ny, model.nz, self._x0 + u, u, v, a,
                derived, simulation_time, frame_index,
            )
            self._writer.submit(write_vtu_structured, *args)
        if self.settings.probes:
            probes = tuple(int(p) for p in self.settings.probes)
            kin, windows = probe_samples(model, state, probes)
            self.probe_logger.log_sampled(
                simulation_time,
                frame_index,
                model.node_count,
                kin,
                probe_derived_host(model, probes, windows),
            )

    def flush(self) -> None:
        self._writer.flush()
