"""Device packing of the general gather path: mesh + preprocess + config ->
torch tensors on one device.

Port of :mod:`civiwave_tpu.mesh.pack`.  The product is two containers of
tensors:

* :class:`PackedModel` — time-invariant tables (connectivity, gradients,
  volumes, materials, masses, boundary conditions, assembly indices) in the
  element-type-blocked layout: tets and hexes get separate tables (tet rows
  carry constant gradients, hex rows the 2x2x2 Gauss tables in gp-major
  order), and assembly is the dual CSR — a padded per-node incidence table
  ``csr_idx (N*, D)`` into the concatenated per-element force rows, with
  0/1 weights, so it is a gather with no float atomics (the reference
  engine's ke_gather_node idea, docs/spec.md:35).
* :class:`SimState` — the evolving kinematic state (u, v, a) plus the PCG
  warm-start vector.

Semantics kept from the reference: fp64 -> fp32 clamps to +/-FLT_MAX
(:func:`clamp_to_f32`); padded connectivity slots point at real nodes with
zero gradients and volumes, so padded elements contribute exact zeros;
padded nodes are fully constrained with zero mass and targets; the CSR
covers real incidences only; elements are sorted by their min corner node
inside each block, so the element kernel's gathered rows stay close
together in L2.  Nodes are RCM-renumbered when that tightens the element
spans (``mesh/renumber.py``); ``to_nodal``/``from_nodal`` translate.

Left out, as TPU-only: the BLOCK_ELEMS = 4096 element padding (only the
``pad_elems`` rounding stays) and the banded gather windows and oct plans
(ROADMAP "Do not port").  Lysmer-Kuhlemeyer absorbing dashpots ride on the
model as (N*, 6) sym-packed node blocks (``physics/absorbing.py``); the
stepper sets ``damp_factor`` (Newmark a1) on a copy of the model per step.

A model can carry the multi-device halo plan (``parallel/general_halo.py``:
the ``halo_*`` fields, stacked over shards) and can be a shard of one
(``parallel.sharding.shard_general``): then its per-node tensors and
vectors are its ``local_rows`` rows, its element and CSR tables are the
ones its operator runs on, ``shard_window`` is the model that operator's
kernels see, and ``to_nodal``/``from_nodal`` stay global.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.schema import Config
from ..physics import absorbing as absorbing_mod
from ..physics import loads as loads_mod
from ..physics import oracle
from ..physics.materials import ElasticProperties, material_tables
from ..utils import profiling
from ..utils.errors import PackError
from .model import Mesh, SENTINEL
from .preprocess import PreprocessOutputs
from .renumber import plan_renumbering

_FLT_MAX = np.float32(np.finfo(np.float32).max)
_INT32_MAX = np.iinfo(np.int32).max


def clamp_to_f32(values: np.ndarray) -> np.ndarray:
    """fp64 -> fp32 with +/-FLT_MAX clamping (pack.cpp:41-57): cast, then
    repair only the entries that overflowed to inf from a finite f64."""
    values = np.asarray(values)
    if values.dtype == np.float32:
        return values  # already in range by construction
    values = np.ascontiguousarray(values, dtype=np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        out = values.astype(np.float32)
    flat_out = out.reshape(-1)
    overflow = np.flatnonzero(np.isinf(flat_out))
    if overflow.size:
        src = values.reshape(-1)[overflow]
        finite = np.isfinite(src)  # keep real inf/nan verbatim
        flat_out[overflow[finite]] = np.sign(src[finite]).astype(
            np.float32
        ) * _FLT_MAX
    return out


def _round_up(value: int, multiple: int) -> int:
    return ((value + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class SimState:
    """Evolving kinematic state + PCG warm-start vector, each in the
    model's vector layout ((3, X, Y, Z) f32 on the structured route,
    (N*, 3) f32 on the general path)."""

    displacement: torch.Tensor
    velocity: torch.Tensor
    acceleration: torch.Tensor
    warm_x: torch.Tensor  # previous PCG solution (or correction, "delta")


def zero_state(model) -> SimState:
    """Zero kinematic state in the model's vector layout."""
    return model.zero_state()


@dataclass(frozen=True, eq=False)
class PackedModel:
    """Time-invariant device tables of the general path (element-type-
    blocked layout).

    Shapes use N* / T* / H* = padded node / tet / hex counts.  The assembly
    tables index into the concatenated force-row array: tet element e slot
    l is row ``e*4 + l``, hex element e slot l is row ``T* * 4 + e*8 + l``.
    Index tensors the kernels read are int32.
    """

    # tet block: gradients node-major transposed (4l, 3, T*), so the
    # element kernel's neighbouring threads read neighbouring addresses
    conn_tet: torch.Tensor  # (T*, 4) int32
    grads_tet: torch.Tensor  # (4l, 3, T*) f32
    vol_tet: torch.Tensor  # (T*,) f32
    lam_tet: torch.Tensor  # (T*,) f32
    mu_tet: torch.Tensor  # (T*,) f32
    mat_tet: torch.Tensor  # (T*,) int32
    # hex block (2x2x2 Gauss), gp-major transposed for the same reason
    conn_hex: torch.Tensor  # (H*, 8) int32
    grads_hex: torch.Tensor  # (8gp, 8l, 3, H*) f32
    vol_hex: torch.Tensor  # (8gp, H*) f32 — detJ per gp
    lam_hex: torch.Tensor  # (H*,) f32
    mu_hex: torch.Tensor  # (H*,) f32
    mat_hex: torch.Tensor  # (H*,) int32
    # gather-based assembly (dual CSR, fixed degree D = csr_degree)
    csr_idx: torch.Tensor  # (N*, D) int32 — rows of the force-row array
    csr_weight: torch.Tensor  # (N*, D) f32 — 1 for real incidences, 0 for pads
    # per node
    position0: torch.Tensor  # (N*, 3) f32
    lumped_mass: torch.Tensor  # (N*,) f32
    bc_mask: torch.Tensor  # (N*, 3) bool
    bc_value: torch.Tensor  # (N*, 3) f32
    # per material
    lam: torch.Tensor  # (M,) f32
    mu: torch.Tensor  # (M,) f32
    stiffness_6x6: torch.Tensor  # (M, 6, 6) f32
    # Lysmer-Kuhlemeyer absorbing dashpots: (N*, 6) sym-packed per-node C
    # (None without boundaries.absorbing groups); damp_factor is the Newmark
    # a1 the stepper sets per step (K_eff += a1 C; None outside a step)
    damp_blocks: Optional[torch.Tensor] = None
    damp_factor: Optional[float] = None
    # RCM node renumbering (None = identity): perm_new_of_old[old] = new,
    # perm_old_of_new inverts it; both padded to N* with an identity tail
    perm_new_of_old: Optional[torch.Tensor] = None  # (N*,) int64
    perm_old_of_new: Optional[torch.Tensor] = None  # (N*,) int64
    # the banded halo plan (parallel/general_halo.py): on an unsharded model
    # the tables of every shard stacked along their element (tables) or row
    # (CSR) axis, as the reference's; on a shard this rank's own, with
    # LOCAL node indices into its (L + G)-row window.  None / "" / 0 without
    halo_conn: Optional[torch.Tensor] = None  # (S*E_s, nl) int32
    halo_grads: Optional[torch.Tensor] = None  # tet (4,3,S*E_s) / hex (8,8,3,S*E_s)
    halo_vol: Optional[torch.Tensor] = None  # tet (S*E_s,) / hex (8, S*E_s)
    halo_lam: Optional[torch.Tensor] = None  # (S*E_s,)
    halo_mu: Optional[torch.Tensor] = None  # (S*E_s,)
    halo_csr_idx: Optional[torch.Tensor] = None  # (S*(L+G), D) int32
    halo_csr_weight: Optional[torch.Tensor] = None  # (S*(L+G), D) f32
    halo_block: str = ""
    halo_local_nodes: int = 0  # L
    halo_ghost: int = 0  # G
    halo_elems: int = 0  # E_s
    # a shard (parallel.sharding.shard_general): its group (a
    # parallel.sharding.ShardGroup, None in in-process checks), its first
    # global row and row count (0: unsharded), and the model its K7 + G1
    # run on: the (L + G)-row window with the next rank's mask rows (the
    # halo form) or the whole model (the all-gather form); None on one rank
    shard_group: Optional[object] = None
    shard_row0: int = 0
    local_rows: int = 0
    shard_window: Optional["PackedModel"] = None
    node_count: int = 0
    padded_node_count: int = 0
    tet_count: int = 0
    padded_tet_count: int = 0
    hex_count: int = 0
    padded_hex_count: int = 0
    element_count: int = 0
    csr_degree: int = 8

    @property
    def has_damping(self) -> bool:
        return self.damp_blocks is not None

    @property
    def psum(self):
        """The shard group's all-reduce (PCG's reduction hook), or None."""
        return None if self.shard_group is None else self.shard_group.psum

    @property
    def halo(self) -> bool:
        """Whether this shard runs the banded halo-exchange operator."""
        return self.shard_window is not None and bool(self.halo_block)

    @property
    def device(self) -> torch.device:
        return self.bc_mask.device

    @property
    def dof_count(self) -> int:
        return self.node_count * 3

    @property
    def force_row_count(self) -> int:
        return self.padded_tet_count * 4 + self.padded_hex_count * 8

    # --- operator protocol (shared with StructuredModel) -------------------
    @property
    def vector_shape(self) -> Tuple[int, ...]:
        """(N*, 3); a shard's (L, 3) rows."""
        return (self.local_rows or self.padded_node_count, 3)

    @property
    def mass_b(self) -> torch.Tensor:
        """Lumped mass broadcastable against solver vectors."""
        return self.lumped_mass[:, None]

    def zero_state(self) -> SimState:
        z = torch.zeros(self.vector_shape, dtype=torch.float32, device=self.device)
        return SimState(z, z, z, z)

    @property
    def renumbered(self) -> bool:
        """Whether pack applied an RCM node permutation."""
        return self.perm_new_of_old is not None

    def to_nodal(self, vector: torch.Tensor) -> torch.Tensor:
        """Solver vector -> (node_count, 3) nodal rows in the MESH's
        original node order (inverse-permuting any RCM renumbering).  On a
        shard, gather the vector first (``parallel.sharding.gather``)."""
        if self.perm_new_of_old is not None:
            vector = vector[self.perm_new_of_old]
        return vector[: self.node_count]

    def from_nodal(self, rows) -> torch.Tensor:
        """(node_count, 3) rows in original mesh order -> solver vector of
        the whole model (a shard's rows: :meth:`own_rows`)."""
        rows = profiling.from_host(rows, self.device)
        full = torch.zeros((self.padded_node_count, 3), dtype=torch.float32,
                           device=self.device)
        full[: self.node_count] = rows[: self.node_count]
        if self.perm_old_of_new is not None:
            full = full[self.perm_old_of_new]
        return full

    def own_rows(self, vector: torch.Tensor) -> torch.Tensor:
        """This shard's rows of a whole-model (N*, ...) tensor (the tensor
        itself on an unsharded model)."""
        if not self.local_rows:
            return vector
        return vector[self.shard_row0:self.shard_row0 + self.local_rows]

    def apply_keff(self, x, stiffness_scale, mass_factor):
        from ..ops import apply_keff as _ops

        if self.shard_window is not None:
            from ..ops import general_sharded as _sharded

            return _sharded.apply_keff_general_sharded(
                self, x, stiffness_scale, mass_factor)
        return _ops.apply_keff(self, x, stiffness_scale, mass_factor)

    def assemble_node_blocks(self, stiffness_scale, mass_factor):
        from ..ops import block_jacobi as _ops

        if self.shard_window is not None:
            from ..ops import general_sharded as _sharded

            return _sharded.node_blocks_general_sharded(
                self, stiffness_scale, mass_factor)
        return _ops.assemble_node_blocks(self, stiffness_scale, mass_factor)

    def build_preconditioner(self, stiffness_scale, mass_factor):
        from ..ops import block_jacobi as _ops

        return _ops.build_block_jacobi_inverse(self, stiffness_scale, mass_factor)

    def apply_preconditioner(self, block_inverse, residual):
        from ..ops import block_jacobi as _ops

        return _ops.apply_preconditioner(self, block_inverse, residual)

    def apply_pc_keff(self, block_inverse, residual, stiffness_scale,
                      mass_factor):
        """(u, w) = (M^-1 r, K_eff u) — plain composition on the general
        path."""
        u = self.apply_preconditioner(block_inverse, residual)
        return u, self.apply_keff(u, stiffness_scale, mass_factor)

    def prefers_fused_pcg(self, block_inverse, vector_dtype) -> bool:
        """'auto' variant probe: the general path has no fused
        pc+matvec+dots kernel, so 'auto' stays classic, as in the
        reference, except on a shard that runs the halo operator (one
        all-reduce per iteration instead of two or three; the reference
        marks only such a model as sharded)."""
        return self.halo

    def absorbing_force(self, v: torch.Tensor) -> torch.Tensor:
        """C v from the dashpots, zeroed on constrained axes (zeros without
        absorbing faces): the Newmark right-hand side's damping force."""
        if not self.has_damping:
            return torch.zeros_like(v)
        from ..physics.absorbing import sym_apply

        return torch.where(self.bc_mask, 0.0, sym_apply(self.damp_blocks, v))


def _build_dual_csr(
    conn_tet: np.ndarray,
    conn_hex: np.ndarray,
    t_pad: int,
    n_pad: int,
    pad_degree: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-node incidence table into the concatenated force-row array.

    Force rows: tet element e slot l -> row e*4 + l; hex element e slot l
    -> row t_pad*4 + e*8 + l.  Padded entries index row 0 with weight 0.
    The degree is the max incidence rounded up to a multiple of 8.
    """
    entries_nodes = []
    entries_rows = []
    if conn_tet.size:
        t = conn_tet.shape[0]
        rows = (
            np.arange(t, dtype=np.int64)[:, None] * 4
            + np.arange(4, dtype=np.int64)[None, :]
        )
        entries_nodes.append(conn_tet.reshape(-1).astype(np.int64))
        entries_rows.append(rows.reshape(-1))
    if conn_hex.size:
        h = conn_hex.shape[0]
        rows = (
            t_pad * 4
            + np.arange(h, dtype=np.int64)[:, None] * 8
            + np.arange(8, dtype=np.int64)[None, :]
        )
        entries_nodes.append(conn_hex.reshape(-1).astype(np.int64))
        entries_rows.append(rows.reshape(-1))

    if entries_nodes:
        nodes = np.concatenate(entries_nodes)
        rows = np.concatenate(entries_rows)
    else:
        nodes = np.zeros(0, np.int64)
        rows = np.zeros(0, np.int64)

    counts = np.bincount(nodes, minlength=n_pad)
    max_degree = int(counts.max()) if counts.size else 0
    degree = max(_round_up(max(max_degree, 1), pad_degree), pad_degree)

    csr_idx = np.zeros((n_pad, degree), dtype=np.int32)
    csr_weight = np.zeros((n_pad, degree), dtype=np.float32)
    order = np.argsort(nodes, kind="stable")
    nodes_sorted = nodes[order]
    rows_sorted = rows[order]
    offsets = np.zeros(n_pad + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    # vectorized ragged fill: position within each node's run
    position = np.arange(len(nodes_sorted)) - offsets[nodes_sorted]
    csr_idx[nodes_sorted, position] = rows_sorted.astype(np.int32)
    csr_weight[nodes_sorted, position] = 1.0
    return csr_idx, csr_weight


def build_packed_model(
    mesh: Mesh,
    preprocess: PreprocessOutputs,
    cfg: Config,
    materials: Sequence[ElasticProperties],
    pad_nodes: int = 8,
    pad_elems: int = 8,
    *,
    device,
) -> Tuple[PackedModel, SimState, torch.Tensor]:
    """Pack everything for residency on ``device`` (pack.cpp:61-235).

    Returns (model, initial_state, external_force) where external_force is
    the (N*, 3) f32 load vector at t = 0.  The host work is vectorised
    numpy; every table is uploaded once.
    """
    if pad_nodes < 1 or pad_elems < 1:
        raise PackError("padding multiples must be >= 1", ["PackingParameters"])

    n = mesh.node_count
    if n != preprocess.lumped_mass.shape[0]:
        raise PackError(
            "preprocess lumped mass count mismatches mesh nodes",
            ["nodes", str(n), "lumped_mass", str(preprocess.lumped_mass.shape[0])],
        )

    n_pad = _round_up(max(n, 1), pad_nodes)

    # --- RCM node renumbering ----------------------------------------------
    perm = iperm = None
    if n > 1:
        pair = plan_renumbering(
            [preprocess.tet_connectivity[:, :4], preprocess.hex_connectivity], n
        )
        if pair is not None:
            perm, iperm = pair

    def _pnode(arr: np.ndarray) -> np.ndarray:
        """Original-order per-node rows -> internal (renumbered) order."""
        return arr if iperm is None else arr[iperm]

    # --- per-node tables -------------------------------------------------
    position0 = np.zeros((n_pad, 3), dtype=np.float32)
    position0[:n] = _pnode(clamp_to_f32(mesh.node_positions))

    lumped_mass = np.zeros(n_pad, dtype=np.float32)
    lumped_mass[:n] = _pnode(clamp_to_f32(preprocess.lumped_mass))

    dirichlet = oracle.build_dirichlet_conditions(mesh, cfg)
    bc_mask = np.zeros((n_pad, 3), dtype=bool)
    bc_mask[:n] = _pnode(dirichlet.mask.reshape(n, 3))
    bc_mask[n:] = True  # padded nodes are fully constrained no-ops
    bc_value = np.zeros((n_pad, 3), dtype=np.float32)
    bc_value[:n] = _pnode(clamp_to_f32(dirichlet.targets.reshape(n, 3)))

    # Lysmer-Kuhlemeyer absorbing dashpots (None without absorbing groups)
    damp_np = absorbing_mod.assemble_dashpots(mesh, preprocess, cfg, materials)
    damp_blocks = None
    if damp_np is not None:
        damp_blocks = np.zeros((n_pad, 6), dtype=np.float32)
        damp_blocks[:n] = _pnode(clamp_to_f32(damp_np))

    load = loads_mod.assemble_load_vector(mesh, cfg, preprocess, 0.0)
    external_force = np.zeros((n_pad, 3), dtype=np.float32)
    external_force[:n] = _pnode(clamp_to_f32(load))

    # --- element blocks ----------------------------------------------------
    lam_np, mu_np, d_np = material_tables(materials)

    t = preprocess.tet_count
    h = preprocess.hex_count
    t_pad = _round_up(t, pad_elems) if t else 0
    h_pad = _round_up(h, pad_elems) if h else 0
    if t_pad * 4 + h_pad * 8 > _INT32_MAX:
        raise PackError(
            "force-row index does not fit int32",
            ["tets", str(t_pad), "hexes", str(h_pad)],
        )

    conn_tet = np.zeros((t_pad, 4), dtype=np.int32)
    grads_tet = np.zeros((4, 3, t_pad), dtype=np.float32)
    vol_tet = np.zeros(t_pad, dtype=np.float32)
    lam_tet = np.zeros(t_pad, dtype=np.float32)
    mu_tet = np.zeros(t_pad, dtype=np.float32)
    mat_tet = np.zeros(t_pad, dtype=np.int32)
    if t:
        rows = preprocess.tet_connectivity
        rows = np.where(rows[:, :4] == SENTINEL, 0, rows[:, :4])
        if perm is not None:
            rows = perm[rows].astype(np.int32)
        # sort by min corner node: neighbouring elements (and threads of
        # the element kernel) gather neighbouring rows of x
        order = np.argsort(rows.min(axis=1), kind="stable")
        conn_tet[:t] = rows[order]
        conn_tet[t:] = conn_tet[t - 1]  # padded elements repeat the last
        grads_tet[:, :, :t] = clamp_to_f32(
            preprocess.tet_gradients[order]
        ).transpose(1, 2, 0)
        vol_tet[:t] = clamp_to_f32(preprocess.tet_volume[order])
        mat_idx = preprocess.tet_material[order]
        mat_tet[:t] = mat_idx
        lam_tet[:t] = clamp_to_f32(lam_np[mat_idx])
        mu_tet[:t] = clamp_to_f32(mu_np[mat_idx])

    conn_hex = np.zeros((h_pad, 8), dtype=np.int32)
    grads_hex = np.zeros((8, 8, 3, h_pad), dtype=np.float32)
    vol_hex = np.zeros((8, h_pad), dtype=np.float32)
    lam_hex = np.zeros(h_pad, dtype=np.float32)
    mu_hex = np.zeros(h_pad, dtype=np.float32)
    mat_hex = np.zeros(h_pad, dtype=np.int32)
    if h:
        rows = preprocess.hex_connectivity
        rows = np.where(rows == SENTINEL, 0, rows)
        if perm is not None:
            rows = perm[rows].astype(np.int32)
        order = np.argsort(rows.min(axis=1), kind="stable")
        conn_hex[:h] = rows[order]
        conn_hex[h:] = conn_hex[h - 1]
        # preprocess emits the hex tables in the gp-major layout already
        grads_hex[:, :, :, :h] = clamp_to_f32(
            preprocess.hex_gradients_gp[:, :, :, order]
        )
        vol_hex[:, :h] = clamp_to_f32(preprocess.hex_detj[:, order])
        mat_idx = preprocess.hex_material[order]
        mat_hex[:h] = mat_idx
        lam_hex[:h] = clamp_to_f32(lam_np[mat_idx])
        mu_hex[:h] = clamp_to_f32(mu_np[mat_idx])

    # the CSR covers REAL incidences only
    csr_idx, csr_weight = _build_dual_csr(conn_tet[:t], conn_hex[:h], t_pad, n_pad)

    def dev(arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=device)

    perm_new_of_old = perm_old_of_new = None
    if perm is not None:
        perm_pad = np.arange(n_pad, dtype=np.int64)
        perm_pad[:n] = perm
        iperm_pad = np.arange(n_pad, dtype=np.int64)
        iperm_pad[:n] = iperm
        perm_new_of_old, perm_old_of_new = dev(perm_pad), dev(iperm_pad)

    model = PackedModel(
        conn_tet=dev(conn_tet),
        grads_tet=dev(grads_tet),
        vol_tet=dev(vol_tet),
        lam_tet=dev(lam_tet),
        mu_tet=dev(mu_tet),
        mat_tet=dev(mat_tet),
        conn_hex=dev(conn_hex),
        grads_hex=dev(grads_hex),
        vol_hex=dev(vol_hex),
        lam_hex=dev(lam_hex),
        mu_hex=dev(mu_hex),
        mat_hex=dev(mat_hex),
        csr_idx=dev(csr_idx),
        csr_weight=dev(csr_weight),
        position0=dev(position0),
        lumped_mass=dev(lumped_mass),
        bc_mask=dev(bc_mask),
        bc_value=dev(bc_value),
        lam=dev(clamp_to_f32(lam_np)),
        mu=dev(clamp_to_f32(mu_np)),
        stiffness_6x6=dev(clamp_to_f32(d_np)),
        damp_blocks=None if damp_blocks is None else dev(damp_blocks),
        perm_new_of_old=perm_new_of_old,
        perm_old_of_new=perm_old_of_new,
        node_count=n,
        padded_node_count=n_pad,
        tet_count=t,
        padded_tet_count=t_pad,
        hex_count=h,
        padded_hex_count=h_pad,
        element_count=mesh.element_count,
        csr_degree=int(csr_idx.shape[1]),
    )
    return model, model.zero_state(), dev(external_force)
