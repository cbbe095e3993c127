"""Checkpoint / resume for long simulations.

Port of :mod:`civiwave_tpu.utils.checkpoint` in the port's own format (a
checkpoint the JAX package wrote with orbax is not read; carry a JAX state
across with ``convert.sim_state_from_arrays``).  Each saved frame is one
file ``frame_<index>.pt`` under the directory: ``torch.save`` of the four
:class:`~civiwave_tpu_torch.mesh.pack.SimState` vectors (u, v, a and the
PCG warm start) as host tensors, the adaptive dt and the simulation clock
as Python floats and the frame index as an int.  A file is written under a
temporary name and renamed, so a killed run leaves no half file; the
newest ``max_to_keep`` stay.

``save`` copies the vectors to the host in the caller's stream order, then
writes the file on a worker thread, one write in flight at a time (the
reference writes asynchronously too); ``wait`` and ``close`` join it.
``restore`` loads onto the model's device and refuses a checkpoint whose
vectors are not the model's layout (shape and dtype).  A sharded run
writes the same file from rank 0, its vectors gathered to the whole
padded model (``solver/stepper.py``), so a checkpoint moves between a
group and the unsharded build of the same padding either way.
"""

from __future__ import annotations

import os
import re
import threading
from typing import List, Optional

import torch

from ..mesh.pack import SimState
from .errors import CwfError

_FIELDS = ("displacement", "velocity", "acceleration", "warm_x")
_NAME = re.compile(r"^frame_(\d+)\.pt$")


class CheckpointManager:
    """SimState and the stepper's scalars per frame, in ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep {max_to_keep}: keep at least one")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def path(self, frame_index: int) -> str:
        return os.path.join(self.directory, f"frame_{int(frame_index):08d}.pt")

    def save(
        self,
        frame_index: int,
        state: SimState,
        current_dt: float,
        accumulated_time: float,
        wait: bool = False,
    ) -> None:
        """Write frame ``frame_index``'s state; the host copy is taken now,
        the file written on the worker thread (joined when ``wait``)."""
        self.wait()
        payload = {
            name: getattr(state, name).detach().to("cpu", copy=True)
            for name in _FIELDS
        }
        payload["current_dt"] = float(current_dt)
        payload["accumulated_time"] = float(accumulated_time)
        payload["frame_index"] = int(frame_index)
        self._writer = threading.Thread(
            target=self._write, args=(int(frame_index), payload), daemon=True
        )
        self._writer.start()
        if wait:
            self.wait()

    def _write(self, frame_index: int, payload: dict) -> None:
        try:
            path = self.path(frame_index)
            tmp = f"{path}.{os.getpid()}.tmp"
            torch.save(payload, tmp)
            os.replace(tmp, path)
            for old in self.steps()[: -self.max_to_keep]:
                os.remove(self.path(old))
        except BaseException as err:  # re-raised by wait()
            self._error = err

    def wait(self) -> None:
        """Join the write in flight; re-raise its error, if any."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def steps(self) -> List[int]:
        """The saved frame indices, oldest first (written files only)."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, frame_index: Optional[int] = None, *, model=None,
                dtype: Optional[torch.dtype] = None, shape=None):
        """Returns (SimState, current_dt, accumulated_time, frame_index) of
        ``frame_index`` (default the latest), the vectors on ``model``'s
        device (the host without a model).  Raises FileNotFoundError when
        there is no such checkpoint and CwfError when its vectors are not
        ``model.vector_shape`` (or ``shape``: a shard's global vectors) or
        not ``dtype``."""
        step = frame_index if frame_index is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        path = self.path(step)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint for frame {step}: {path}")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        device = "cpu" if model is None else model.device
        if model is not None:
            shape = model.vector_shape
        vectors = []
        for name in _FIELDS:
            v = payload[name]
            if shape is not None and tuple(v.shape) != tuple(shape):
                raise CwfError(
                    f"checkpoint {name} has shape {tuple(v.shape)}, the model's "
                    f"vectors {tuple(shape)}", [path])
            if dtype is not None and v.dtype != dtype:
                raise CwfError(
                    f"checkpoint {name} is {v.dtype}, the run's vectors {dtype} "
                    "(precision.vectors)", [path])
            vectors.append(v.to(device))
        return (
            SimState(*vectors),
            float(payload["current_dt"]),
            float(payload["accumulated_time"]),
            int(payload["frame_index"]),
        )

    def close(self) -> None:
        self.wait()
