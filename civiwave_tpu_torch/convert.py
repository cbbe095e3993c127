"""Carry model and solver state across from host arrays.

The structured model, the general path's packed model, the solver state
and the block-Jacobi class table are plain arrays plus a few scalars, so a
run can be handed over from any source that can export them as numpy (the
JAX reference package, a file) and continued in this package on any
device.  The tests use it to feed both packages the same model (the same
element order and node numbering) and state.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from .mesh.pack import PackedModel, SimState
from .mesh.structured import StructuredModel, interior_mass
from .ops.structured import (
    CompactBlockJacobi,
    class_stencil_table,
    mass_correction,
    sweep_taps,
)

# array fields of a structured model, with their storage dtypes
STRUCTURED_ARRAYS = {
    "lam_grid": np.float32,
    "mu_grid": np.float32,
    "mass_grid": np.float32,
    "bc_mask": np.bool_,
    "bc_value": np.float32,
    "position0": np.float32,
}
# scalar fields (the dead +X planes and +Y rows, whether one material
# fills the grid, the absorbing faces and their impedances included; the
# stepper sets damp_factor per step)
STRUCTURED_META = (
    "nx", "ny", "nz", "node_count", "padded_node_count", "pad_planes",
    "pad_rows", "spacing", "homogeneous", "lam0", "mu0", "absorb_faces",
    "rho_cp", "rho_cs",
)


def structured_model_from_arrays(
    arrays: Mapping[str, np.ndarray], meta: Mapping[str, object], device,
    levels: Sequence[Tuple[Mapping[str, np.ndarray], Mapping[str, object]]] = (),
) -> StructuredModel:
    """A :class:`StructuredModel` on ``device`` from its array fields (as
    numpy) and its scalar fields (``pad_rows`` defaults to 0,
    ``homogeneous`` to True; a heterogeneous model's per-cell
    ``lam_grid``/``mu_grid`` are its material).  ``meta`` may also carry a
    multigrid hierarchy's ``preconditioner`` and ``mg_omegas``, whose
    coarse levels are ``levels``: one ``(arrays, meta)`` pair per level,
    finest first, each carried with the mass correction its kernels need
    (``ops.structured.mass_correction``)."""
    fields = {
        name: torch.as_tensor(np.array(arrays[name], dtype), device=device)
        for name, dtype in STRUCTURED_ARRAYS.items()
    }
    spacing = tuple(float(s) for s in meta["spacing"])
    lam0, mu0 = float(meta["lam0"]), float(meta["mu0"])
    nx, ny, nz = (int(meta[k]) for k in ("nx", "ny", "nz"))
    mg_levels = []
    for level_arrays, level_meta in levels:
        level = structured_model_from_arrays(level_arrays, level_meta, device)
        mg_levels.append(dataclasses.replace(
            level, mass_correction=mass_correction(level)
        ))
    return StructuredModel(
        **fields,
        stencil_table=torch.as_tensor(
            class_stencil_table(spacing, lam0, mu0), device=device
        ),
        sweep_taps=sweep_taps(spacing, lam0, mu0),
        nx=nx,
        ny=ny,
        nz=nz,
        node_count=int(meta["node_count"]),
        padded_node_count=int(meta["padded_node_count"]),
        pad_planes=int(meta["pad_planes"]),
        pad_rows=int(meta.get("pad_rows", 0)),
        spacing=spacing,
        homogeneous=bool(meta.get("homogeneous", True)),
        lam0=lam0,
        mu0=mu0,
        m8=interior_mass(np.asarray(arrays["mass_grid"], np.float32), nx, ny, nz),
        absorb_faces=tuple(meta["absorb_faces"]),
        rho_cp=float(meta["rho_cp"]),
        rho_cs=float(meta["rho_cs"]),
        preconditioner=str(meta.get("preconditioner", "block_jacobi")),
        mg_levels=tuple(mg_levels),
        mg_omegas=tuple(float(w) for w in meta.get("mg_omegas", ())),
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


# array fields of a packed model, with their storage dtypes (the JAX
# model's padding is accepted as it stands: it is 4096-aligned on large
# blocks, and padded elements are exact no-ops either way)
PACKED_ARRAYS = {
    "conn_tet": np.int32,
    "grads_tet": np.float32,
    "vol_tet": np.float32,
    "lam_tet": np.float32,
    "mu_tet": np.float32,
    "mat_tet": np.int32,
    "conn_hex": np.int32,
    "grads_hex": np.float32,
    "vol_hex": np.float32,
    "lam_hex": np.float32,
    "mu_hex": np.float32,
    "mat_hex": np.int32,
    "csr_idx": np.int32,
    "csr_weight": np.float32,
    "position0": np.float32,
    "lumped_mass": np.float32,
    "bc_mask": np.bool_,
    "bc_value": np.float32,
    "lam": np.float32,
    "mu": np.float32,
    "stiffness_6x6": np.float32,
}
# optional arrays: the RCM permutation (None = identity numbering) and the
# absorbing dashpots (None = no absorbing faces; ``meta["has_damping"]``,
# where given, must agree)
PACKED_OPTIONAL = {
    "perm_new_of_old": np.int64,
    "perm_old_of_new": np.int64,
    "damp_blocks": np.float32,
}
PACKED_META = (
    "node_count", "padded_node_count", "tet_count", "padded_tet_count",
    "hex_count", "padded_hex_count", "element_count", "csr_degree",
)
# the multi-device halo plan (the reference's parallel/general_halo.py,
# attached by its shard_simulation): seven arrays, stacked over shards,
# and four scalars; all or none
PACKED_HALO = {
    "halo_conn": np.int32,
    "halo_grads": np.float32,
    "halo_vol": np.float32,
    "halo_lam": np.float32,
    "halo_mu": np.float32,
    "halo_csr_idx": np.int32,
    "halo_csr_weight": np.float32,
}
PACKED_HALO_META = ("halo_block", "halo_local_nodes", "halo_ghost",
                    "halo_elems")


def packed_model_from_arrays(
    arrays: Mapping[str, np.ndarray], meta: Mapping[str, object], device
) -> PackedModel:
    """A :class:`PackedModel` on ``device`` from its array fields (as
    numpy: ``PACKED_ARRAYS`` plus the optional ``PACKED_OPTIONAL`` and
    ``PACKED_HALO``) and its scalar fields (``PACKED_META``, and
    ``PACKED_HALO_META`` with the halo arrays).  Some but not all halo
    arrays, or halo arrays without their scalars, raise ValueError, as
    does ``meta["has_damping"]`` without ``damp_blocks`` (or the
    reverse)."""
    halo = [k for k in PACKED_HALO if arrays.get(k) is not None]
    if halo and (len(halo) != len(PACKED_HALO)
                 or any(meta.get(k) in (None, "") for k in PACKED_HALO_META)):
        raise ValueError(
            f"halo arrays {halo} need all of {sorted(PACKED_HALO)} and the "
            f"scalars {list(PACKED_HALO_META)}"
        )
    has_blocks = arrays.get("damp_blocks") is not None
    if "has_damping" in meta and bool(meta["has_damping"]) != has_blocks:
        raise ValueError(
            f"has_damping={meta['has_damping']} but damp_blocks is "
            f"{'given' if has_blocks else 'None'}"
        )
    fields = {
        name: torch.as_tensor(np.array(arrays[name], dtype), device=device)
        for name, dtype in PACKED_ARRAYS.items()
    }
    for name, dtype in {**PACKED_OPTIONAL, **PACKED_HALO}.items():
        value = arrays.get(name)
        fields[name] = (
            None if value is None
            else torch.as_tensor(np.array(value, dtype), device=device)
        )
    if halo:
        fields["halo_block"] = str(meta["halo_block"])
        fields.update({k: int(meta[k]) for k in PACKED_HALO_META[1:]})
    return PackedModel(**fields, **{k: int(meta[k]) for k in PACKED_META})
