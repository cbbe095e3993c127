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

A sharded run (``parallel.sharding.shard_simulation``) keeps its manager.
Every rank calls ``handle_from_stepper`` in the frame loop, in the same
order, since it makes collectives; only rank 0 gets the gathered fields
and writes, through the same writer and the same file names, so the
output directory holds exactly the files of the unsharded run.  The
gathers are issued from the frame loop, never from the writer thread.
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
        """Pull the nodal views from the stepper and run the frame.  On a
        shard a collective: u, v and a are gathered to rank 0 (three
        gathers), whose host work is the unsharded run's."""
        views = stepper.host_kinematics()
        if views is not None:
            self.handle_frame(simulation_time, frame_index, *views)

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
    with implicit connectivity.  On a shard each rank derives its block's
    fields, and a VTU frame gathers them with u, v and a to rank 0 (nine
    gathers; the derived fields' ghost exchange adds 2 or 4 ``ppermute``);
    every frame's probe rows come to rank 0 in one gather."""

    def __init__(
        self,
        output_root: str,
        settings: OutputSettings,
        model,
    ) -> None:
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
            gather_derived,
            probe_rows,
        )

        model = self.model
        state = stepper.state
        vectors = (state.displacement, state.velocity, state.acceleration)
        if frame_index % max(self.settings.vtu_stride, 1) == 0:
            fields = compute_structured_derived(model, state.displacement)
            if model.shard_group is not None:
                from ..parallel.sharding import gather_structured

                fields = gather_derived(model, fields)
                vectors = [gather_structured(t, model.shard_group, 0)
                           for t in vectors]
            if fields is not None:
                derived = derived_to_host(model, fields)
                u, v, a = (model.to_nodal(t).cpu().numpy() for t in vectors)
                if self._x0 is None:
                    self._x0 = model.position0[: model.node_count].cpu().numpy()
                args = (
                    _vtu_path(self.output_root, frame_index),
                    model.nx, model.ny, model.nz, self._x0 + u, u, v, a,
                    derived, simulation_time, frame_index,
                )
                self._writer.submit(write_vtu_structured, *args)
        if self.settings.probes:
            rows = probe_rows(model, state, self.settings.probes)
            if rows is not None:
                self.probe_logger.log_sampled(
                    simulation_time, frame_index, model.node_count, *rows)

    def flush(self) -> None:
        self._writer.flush()
