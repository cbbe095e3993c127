"""Carry model and solver state across from host arrays.

The structured model, the solver state and the block-Jacobi class table are
plain arrays plus a few scalars, so a run can be handed over from any
source that can export them as numpy (the JAX reference package, a file)
and continued in this package on any device.  The tests use it to feed
both packages the same model and state.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .mesh.pack import SimState
from .mesh.structured import StructuredModel, interior_mass
from .ops.structured import CompactBlockJacobi, class_stencil_table

# array fields of a structured model, with their storage dtypes
STRUCTURED_ARRAYS = {
    "lam_grid": np.float32,
    "mu_grid": np.float32,
    "mass_grid": np.float32,
    "bc_mask": np.bool_,
    "bc_value": np.float32,
    "position0": np.float32,
}
# scalar fields; a source with Y dead rows or a heterogeneous grid is
# refused (not ported)
STRUCTURED_META = (
    "nx", "ny", "nz", "node_count", "padded_node_count", "pad_planes",
    "spacing", "lam0", "mu0",
)


def structured_model_from_arrays(
    arrays: Mapping[str, np.ndarray], meta: Mapping[str, object], device
) -> StructuredModel:
    """A :class:`StructuredModel` on ``device`` from its array fields (as
    numpy) and its scalar fields.  ``meta`` may also carry ``pad_rows`` and
    ``homogeneous``; anything but 0 / True raises NotImplementedError."""
    if meta.get("pad_rows", 0):
        raise NotImplementedError(
            "dead +Y rows (2-D slab decomposition) are not ported (ROADMAP A11)"
        )
    if not meta.get("homogeneous", True):
        raise NotImplementedError(
            "heterogeneous structured grids are not ported yet"
        )
    fields = {
        name: torch.as_tensor(np.array(arrays[name], dtype), device=device)
        for name, dtype in STRUCTURED_ARRAYS.items()
    }
    spacing = tuple(float(s) for s in meta["spacing"])
    lam0, mu0 = float(meta["lam0"]), float(meta["mu0"])
    nx, ny, nz = (int(meta[k]) for k in ("nx", "ny", "nz"))
    return StructuredModel(
        **fields,
        stencil_table=torch.as_tensor(
            class_stencil_table(spacing, lam0, mu0), device=device
        ),
        nx=nx,
        ny=ny,
        nz=nz,
        node_count=int(meta["node_count"]),
        padded_node_count=int(meta["padded_node_count"]),
        pad_planes=int(meta["pad_planes"]),
        spacing=spacing,
        lam0=lam0,
        mu0=mu0,
        m8=interior_mass(np.asarray(arrays["mass_grid"], np.float32), nx, ny, nz),
    )


def sim_state_from_arrays(u, v, a, warm_x, device) -> SimState:
    """A :class:`SimState` (displacement, velocity, acceleration, warm_x)
    on ``device`` from four f32 arrays in the model's vector layout."""
    return SimState(
        *(
            torch.as_tensor(np.array(t, np.float32), device=device)
            for t in (u, v, a, warm_x)
        )
    )


def compact_pc_from_array(table, device) -> CompactBlockJacobi:
    """The (6, 3, 3, 3) block-Jacobi class table on ``device``."""
    table = np.array(table, np.float32)
    if table.shape != (6, 3, 3, 3):
        raise ValueError(f"class table shape {table.shape}, expected (6, 3, 3, 3)")
    return CompactBlockJacobi(table=torch.as_tensor(table, device=device))
