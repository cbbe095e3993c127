"""X-slab and (X, Y)-tile decomposition of the structured route over
``torch.distributed``.

Port of the structured half of :mod:`civiwave_tpu.parallel.sharding`
(its ``make_device_mesh``/``make_device_mesh_2d`` and
``shard_structured``).  One process per device: a rank holds its shard of
every node-grid field as a :class:`~civiwave_tpu_torch.mesh.structured.
StructuredModel` whose tensors are local, and the matvec exchanges ghost
planes (and, in 2-D, ghost rows) with its neighbours
(``ops/structured_sharded.py``).

* :func:`make_shard_group` / :func:`make_shard_group_2d` describe the
  group: NCCL with one GPU per rank on CUDA, gloo on the CPU.  A world of
  one is initialised here from an in-memory ``HashStore`` (no network);
  several ranks need ``torch.distributed`` initialised by their launcher
  first (``parallel/launch.py``).  More ranks than visible GPUs raise
  :class:`ShardError`; nothing falls back to the CPU.
* :func:`shard_structured` cuts this rank's slab or tile from the model,
  the state and the force, and exchanges the Dirichlet mask's ghosts once
  (the mask is loop-invariant; the reference's compiled program hoists
  that exchange out of its PCG body), and on a heterogeneous grid the
  ghost cells of λ and μ once too.
* :func:`shard_simulation` does the same to a whole
  ``runner.Simulation`` (its force schedule included) and gives it a
  stepper over the shard: the one way the launcher, ``chip_smoke.py`` and
  the tests build a sharded run.
* :func:`gather_structured` reassembles a global ``(3, X, Y, Z)`` vector
  for host-facing output (the stepper's ``displacement()`` and the like
  call it on a shard); with ``dst`` only that rank gets it (a shard's
  output manager, probes and checkpoints gather to rank 0, which writes).

Ranks are ordered X-major: rank ``px * npy + py`` holds tile ``(px, py)``,
as the reference's 2-D mesh lays X slowest.

The general path (the reference's ``shard_simulation`` of a packed model)
shards over a 1-D group by contiguous node rows: :func:`shard_general`
gives rank s rows ``[s L, (s+1) L)`` (L = N*/n; build with
``pad_nodes`` a multiple of n) and, where the banded halo plan holds
(``parallel/general_halo.py``), its elements, their (L + G)-row window
and the next rank's mask rows (exchanged once); elsewhere, or with
``CIVIWAVE_GENERAL_HALO=0``, it keeps the whole model's tables for the
all-gather form (``ops/general_sharded.py``).  One rank keeps the
single-device operator with the group's reductions, as the reference.
:func:`gather` reassembles a global vector of either route, on every
rank or on one.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..mesh.pack import PackedModel, SimState
from ..utils.errors import ShardError
from . import collectives


@dataclass(frozen=True)
class ShardGroup:
    """A 1-D (``two_d`` False, ``npy`` 1) or 2-D (X, Y) group of ranks over
    the default ``torch.distributed`` group, and this rank's place in it."""

    npx: int
    npy: int
    two_d: bool
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        return self.npx * self.npy

    @property
    def coords(self) -> Tuple[int, int]:
        return divmod(self.rank, self.npy)

    def _rank(self, px: int, py: int) -> int:
        return px * self.npy + py

    def pairs(self, axis: int, step: int) -> List[Tuple[int, int]]:
        """(src, dst) rank pairs of a shift by ``step`` (+1 or -1) along
        ``axis`` (0 = X, 1 = Y); the ends send or receive nothing."""
        out = []
        for px in range(self.npx):
            for py in range(self.npy):
                qx, qy = (px + step, py) if axis == 0 else (px, py + step)
                if 0 <= qx < self.npx and 0 <= qy < self.npy:
                    out.append((self._rank(px, py), self._rank(qx, qy)))
        return out

    def psum(self, tensor: torch.Tensor) -> torch.Tensor:
        """All-reduce sum over the group (PCG's reduction hook)."""
        return collectives.psum(tensor)


def _init_group(n: int, device: torch.device) -> None:
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise ShardError(
            "requested more ranks than visible GPUs (one GPU per rank)",
            [f"requested={n}", f"visible={torch.cuda.device_count()}"],
        )
    if not dist.is_initialized():
        if n != 1:
            raise ShardError(
                "torch.distributed is not initialised: several ranks need "
                "their launcher to initialise it (parallel/launch.py)",
                [f"requested={n}"],
            )
        dist.init_process_group(
            backend, store=dist.HashStore(), rank=0, world_size=1
        )
    world = dist.get_world_size()
    if world != n:
        raise ShardError(
            "the shard group must span every rank of the process group",
            [f"requested={n}", f"world={world}"],
        )
    if dist.get_backend() != backend:
        raise ShardError(
            f"a {device.type} shard group needs the {backend} backend",
            [f"backend={dist.get_backend()}"],
        )


def _local_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        rank = dist.get_rank()
        torch.cuda.set_device(rank)
        return torch.device("cuda", rank)
    return device


def _make(npx: int, npy: int, two_d: bool, device) -> ShardGroup:
    device = torch.device(device)
    _init_group(npx * npy, device)
    group = ShardGroup(
        npx=npx, npy=npy, two_d=two_d, rank=dist.get_rank(),
        device=_local_device(device),
    )
    # a first collective that is not point-to-point (NCCL requires every
    # rank in a group's first batched send/receive); counted nowhere
    dist.all_reduce(torch.zeros(1, device=group.device))
    return group


def make_shard_group(n: int | None = None, device="cuda") -> ShardGroup:
    """1-D group of ``n`` ranks (default: the whole initialised world, or
    one rank) decomposing X into slabs."""
    if n is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
    return _make(n, 1, False, device)


def make_shard_group_2d(npx: int, npy: int, device="cuda") -> ShardGroup:
    """2-D (X, Y) group of ``npx * npy`` ranks decomposing the grid into
    tiles (the ghost-Y form of the operator, even at ``npy`` 1)."""
    return _make(npx, npy, True, device)


def close_shard_group() -> None:
    """Tear down the default process group (if any)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_layout(model, group_shape, coords):
    """``(x0, y0, Xl, Yl)`` of tile ``coords`` of a ``(npx, npy)`` group:
    its node offsets in the global grid and its local extents, after the
    reference's divisibility checks."""
    npx, npy = group_shape
    gx, gy, _ = model.global_grid_shape
    if gx % npx:
        raise ShardError(
            "grid X extent must divide the shard group "
            "(build with pad_x_multiple=npx)",
            [f"X={gx}", f"ranks={npx}"],
        )
    if gy % npy:
        raise ShardError(
            "grid Y extent must divide the shard group "
            "(build with pad_y_multiple=npy)",
            [f"Y={gy}", f"ranks={npy}"],
        )
    xl, yl = gx // npx, gy // npy
    return coords[0] * xl, coords[1] * yl, xl, yl


def cut_block(t: torch.Tensor, x0: int, y0: int, xl: int, yl: int):
    """The (x, y) block of a node-grid tensor ``(..., X, Y, Z)``."""
    return t[..., x0:x0 + xl, y0:y0 + yl, :].contiguous()


def local_model(model, group_shape, coords, device=None):
    """The shard model of tile ``coords`` without its group and without its
    mask ghosts or ghost cells: every node-grid field cut to the tile (the material cell
    grids to the cells whose low corner is a node of the tile), the
    stencil table and ``position0`` as they are, ``grid_shape`` local."""
    x0, y0, xl, yl = shard_layout(model, group_shape, coords)
    device = model.device if device is None else torch.device(device)

    def cut(t):
        return cut_block(t, x0, y0, xl, yl).to(device)

    return dataclasses.replace(
        model,
        lam_grid=model.lam_grid[x0:x0 + xl, y0:y0 + yl].contiguous().to(device),
        mu_grid=model.mu_grid[x0:x0 + xl, y0:y0 + yl].contiguous().to(device),
        mass_grid=cut(model.mass_grid),
        bc_mask=cut(model.bc_mask),
        bc_value=cut(model.bc_value),
        position0=model.position0.to(device),
        stencil_table=model.stencil_table.to(device),
        x0=x0, y0=y0, local_extent=(xl, yl),
    )


def local_tiles(model, group_shape, two_d: bool):
    """Every tile's shard model of a ``(npx, npy)`` cut (1-D with
    ``two_d`` False), each with its mask ghosts cut from the global mask
    (and on a heterogeneous grid its ghost cells from the global cell
    grids): what :func:`shard_structured` gives each rank, in one process
    and without a group (for checks of the shard operator)."""
    from ..ops.structured_sharded import cut_cell_ghosts, cut_ghosts

    tiles = []
    for px in range(group_shape[0]):
        for py in range(group_shape[1]):
            local = local_model(model, group_shape, (px, py))
            at = (local.x0, local.y0, *local.local_extent, two_d)
            cells = None if model.homogeneous else cut_cell_ghosts(
                model.lam_grid, model.mu_grid, *at)
            tiles.append(dataclasses.replace(
                local, bc_ghosts=cut_ghosts(model.bc_mask, *at),
                cell_ghosts=cells))
    return tiles


def shard_structured(model, state: SimState, external_force, group: ShardGroup):
    """This rank's shard of a StructuredModel simulation: ``(model, state,
    force)`` cut to its slab (1-D group) or tile (2-D group) on the group's
    device, the model carrying the group, its offsets and the mask's ghost
    planes and rows, and on a heterogeneous grid (per-cell λ/μ; the
    reference shards it under GSPMD) its ghost cells.  A multigrid model's
    shard falls back to block-Jacobi with a note on stderr.  A collective:
    every rank of the group calls it."""
    from ..ops.structured_sharded import exchange_cell_ghosts, exchange_ghosts

    if model.shard_group is not None:
        raise ShardError("the model is already a shard")
    if model.preconditioner == "multigrid":
        from ..ops.multigrid import SHARD_REASON, fall_back_to_block_jacobi

        model = fall_back_to_block_jacobi(model, SHARD_REASON)
    shape = (group.npx, group.npy)
    x0, y0, xl, yl = shard_layout(model, shape, group.coords)

    def cut(t):
        return cut_block(t, x0, y0, xl, yl).to(group.device)

    local = local_model(model, shape, group.coords, group.device)
    bc = local.bc_mask.to(torch.uint8)
    ghosts = exchange_ghosts(bc, group)
    bc_ghosts = type(ghosts)(*(None if g is None else g.bool() for g in ghosts))
    cells = None if model.homogeneous else exchange_cell_ghosts(
        local.lam_grid, local.mu_grid, group)
    local = dataclasses.replace(local, shard_group=group, bc_ghosts=bc_ghosts,
                                cell_ghosts=cells)
    fields = (state.displacement, state.velocity, state.acceleration,
              state.warm_x)
    return local, SimState(*(cut(v) for v in fields)), cut(external_force)


def shard_simulation(sim, group: ShardGroup):
    """This rank's shard of ``sim``, a ``runner.Simulation``: on the
    structured route a grid that divides the group (build it with
    ``build_simulation(..., pad_x_multiple=npx, pad_y_multiple=npy)``),
    its model, state and force cut by :func:`shard_structured` and each
    part of its force schedule cut to the same block; on the general path
    a packed model whose N* divides the 1-D group (``pad_nodes`` a
    multiple of n), cut by :func:`shard_general` (its curve loads are cut
    per frame, ``Simulation._force_at``).  Either gets a new
    ``NewmarkStepper`` over the shard with the old one's settings, dt,
    time and frame.  A collective: every rank of the group calls it.  The
    simulation's output goes with it: every rank computes its share and
    rank 0 writes the files an unsharded run writes
    (``post/output.py``)."""
    from ..mesh.structured_config import StructuredForceSchedule
    from ..post.output import StructuredOutputManager
    from ..solver.stepper import NewmarkStepper

    old = sim.stepper
    schedule = None
    if sim.force_schedule is None:
        model, state, force = shard_general(
            sim.model, old.state, old.external_force, group
        )
    else:
        model, state, force = shard_structured(
            sim.model, old.state, old.external_force, group
        )
        x0, y0, (xl, yl) = model.x0, model.y0, model.local_extent

        def cut(t):
            return cut_block(t, x0, y0, xl, yl).to(group.device)

        schedule = StructuredForceSchedule(
            base=cut(sim.force_schedule.base),
            curve_parts=[(name, cut(part))
                         for name, part in sim.force_schedule.curve_parts],
        )
    stepper = NewmarkStepper(
        model, state, force, old.rayleigh, old.solver_settings,
        old.time_settings, adaptive_policy=old.adaptive_policy,
        newmark_beta=old.newmark_beta, newmark_gamma=old.newmark_gamma,
        warm_start=old.warm_start_enabled,
        reduction_precision=old.reduction_precision,
        vector_precision=old.vector_precision,
        warm_start_policy=old.warm_start_policy,
        solver_variant=old.solver_variant,
    )
    stepper.solver_replace_every = old.solver_replace_every
    stepper.current_dt = old.current_dt
    stepper.accumulated_time = old.accumulated_time
    stepper.frame_index = old.frame_index
    output = sim.output
    if isinstance(output, StructuredOutputManager):
        output = StructuredOutputManager(output.output_root, output.settings,
                                         model)
    return dataclasses.replace(sim, model=model, stepper=stepper,
                               force_schedule=schedule, output=output)


def gather_structured(vector: torch.Tensor, group: ShardGroup,
                      dst: int | None = None):
    """The global ``(..., X, Y, Z)`` grid from every rank's block, on the
    group's device (a collective): on every rank (an all-gather, not
    counted; the block itself on one rank), or with ``dst`` on that rank
    only, None on the others (a counted ``collectives.gather``, one call
    on a group of one too)."""
    if dst is None:
        if group.size == 1:
            return vector
        parts = [torch.empty_like(vector) for _ in range(group.size)]
        dist.all_gather(parts, vector.contiguous())
    else:
        parts = collectives.gather(vector, dst)
        if parts is None:
            return None
    rows = [
        torch.cat(parts[px * group.npy:(px + 1) * group.npy], dim=-2)
        for px in range(group.npx)
    ]
    return torch.cat(rows, dim=-3)


def gather(model, vector: torch.Tensor, dst: int | None = None):
    """The global vector of a shard's ``vector`` (a collective; the
    vector itself on one rank without ``dst``): :func:`gather_general` on
    the general path, :func:`gather_structured` on the structured route;
    with ``dst`` on that rank only (None on the others)."""
    if isinstance(model, PackedModel):
        return gather_general(vector, model.shard_group, dst)
    return gather_structured(vector, model.shard_group, dst)


# --- the general path -------------------------------------------------------


def gather_general(vector: torch.Tensor, group: ShardGroup,
                   dst: int | None = None):
    """The global ``(N*, ...)`` vector from every rank's rows in rank
    order (a collective): an all-gather, not counted, or with ``dst`` a
    counted gather to that rank (None on the others)."""
    if dst is not None:
        parts = collectives.gather(vector, dst)
        return None if parts is None else torch.cat(parts)
    if group.size == 1:
        return vector
    return collectives.all_gather(vector, count=False)


def general_plan(model: PackedModel, n: int):
    """The halo plan of ``model`` over ``n`` shards as a dict
    (``general_halo.HALO_ARRAYS`` + ``HALO_META``): the tables the model
    carries (``convert`` brings the reference's across) where they were
    made for ``n`` shards, else :func:`general_halo.plan_general_halo`'s
    (None where no plan holds)."""
    from .general_halo import HALO_ARRAYS, HALO_META, plan_general_halo

    if (model.halo_conn is not None
            and model.halo_local_nodes * n == model.padded_node_count):
        return {k: getattr(model, k) for k in HALO_ARRAYS + HALO_META}
    return plan_general_halo(model, n)


def _own(array, device) -> torch.Tensor:
    """A contiguous tensor of its own on ``device`` (never a view: the
    kernels read conn as int4 and CSR rows as 16-byte copies)."""
    if isinstance(array, np.ndarray):
        return torch.tensor(np.ascontiguousarray(array), device=device)
    return array.to(device).clone(memory_format=torch.contiguous_format)


def _without_elements(model: PackedModel) -> PackedModel:
    """``model`` with empty element and CSR tables (new tensors, so the
    whole model's are not kept alive): a shard's, whose K7 + G1 run on its
    ``shard_window``."""
    def empty(t, axis):
        shape = list(t.shape)
        shape[axis] = 0
        return t.new_empty(shape)

    tables = {}
    for block in ("tet", "hex"):
        for k in ("conn", "lam", "mu", "mat"):
            tables[f"{k}_{block}"] = empty(getattr(model, f"{k}_{block}"), 0)
        for k in ("grads", "vol"):
            tables[f"{k}_{block}"] = empty(getattr(model, f"{k}_{block}"), -1)
    return dataclasses.replace(
        model, **tables, csr_idx=empty(model.csr_idx, 0),
        csr_weight=empty(model.csr_weight, 0), padded_tet_count=0,
        padded_hex_count=0)


def _halo_shard(model, plan, s: int, bc_ghost, device):
    """Shard ``s`` of ``model`` under ``plan``, halo form: its rows of the
    per-node tensors and the plan's scalars, and ``shard_window``, the
    (L + G)-row model its K7 + G1 run on: its block's element and CSR
    tables (each its own tensor; the plan holds for one block only, so the
    other is empty), its rows, then G ghost rows with zero mass and the
    next shard's first G mask rows (``bc_ghost``, False past the end)."""
    from .general_halo import HALO_ARRAYS

    L, G, E = (int(plan[k]) for k in
               ("halo_local_nodes", "halo_ghost", "halo_elems"))
    e = slice(s * E, (s + 1) * E)
    r = slice(s * (L + G), (s + 1) * (L + G))
    block = plan["halo_block"]
    rows = slice(s * L, (s + 1) * L)
    no_halo = {k: None for k in HALO_ARRAYS}

    def cut(t):
        return None if t is None else _own(t[rows], device)

    def ext(t, fill):
        return torch.cat([cut(t), fill.to(device)])

    window = dataclasses.replace(
        model,
        **{f"{k}_{block}": _own(plan[f"halo_{k}"][e], device)
           for k in ("conn", "lam", "mu")},
        **{f"{k}_{block}": _own(plan[f"halo_{k}"][..., e], device)
           for k in ("grads", "vol")},
        **{f"mat_{block}": torch.zeros(E, dtype=torch.int32, device=device),
           f"padded_{block}_count": E},
        csr_idx=_own(plan["halo_csr_idx"][r], device),
        csr_weight=_own(plan["halo_csr_weight"][r], device),
        position0=ext(model.position0, torch.zeros((G, 3))),
        lumped_mass=ext(model.lumped_mass, torch.zeros(G)),
        bc_mask=ext(model.bc_mask, bc_ghost),
        bc_value=ext(model.bc_value, torch.zeros((G, 3))),
        damp_blocks=None, damp_factor=None, perm_new_of_old=None,
        perm_old_of_new=None, node_count=L + G, padded_node_count=L + G,
        **no_halo, halo_block="", halo_local_nodes=0, halo_ghost=0,
        halo_elems=0,
    )
    return dataclasses.replace(
        _without_elements(model), **no_halo,
        halo_block=block, halo_local_nodes=L, halo_ghost=G, halo_elems=E,
        position0=cut(model.position0), lumped_mass=cut(model.lumped_mass),
        bc_mask=cut(model.bc_mask), bc_value=cut(model.bc_value),
        damp_blocks=cut(model.damp_blocks), shard_row0=s * L, local_rows=L,
        shard_window=window,
    )


def _row_shard(model, s: int, n: int, window):
    """Shard ``s`` of ``n`` without a plan: its rows of the per-node
    tensors; its K7 + G1 run on ``window`` (the whole model; None on one
    rank, whose operator is the model's own)."""
    L = model.padded_node_count // n
    rows = slice(s * L, (s + 1) * L)

    def cut(t):
        return None if t is None else t[rows]

    # the mask's rows of their own: a view starts s L * 3 bytes in, and the
    # fused PCG loop's direction update reads the mask as 4-byte words
    return dataclasses.replace(
        model if window is None else _without_elements(window),
        position0=cut(model.position0), lumped_mass=cut(model.lumped_mass),
        bc_mask=_own(cut(model.bc_mask), model.bc_mask.device),
        bc_value=cut(model.bc_value),
        damp_blocks=cut(model.damp_blocks), damp_factor=None,
        shard_row0=s * L, local_rows=L, shard_window=window,
    )


def _check_general(model, n: int) -> None:
    if model.shard_window is not None or model.local_rows:
        raise ShardError("the model is already a shard")
    if model.padded_node_count % n:
        raise ShardError(
            "the padded node count must divide the shard group "
            "(build with pad_nodes = 8 * n)",
            [f"nodes={model.padded_node_count}", f"ranks={n}"],
        )


def _halo_enabled() -> bool:
    """The reference's switch: ``CIVIWAVE_GENERAL_HALO=0`` forces the
    fallback (all-gather here, GSPMD there)."""
    return os.environ.get("CIVIWAVE_GENERAL_HALO", "auto") != "0"


def shard_general(model: PackedModel, state: SimState, external_force,
                  group: ShardGroup):
    """This rank's shard of a PackedModel simulation over a 1-D group:
    ``(model, state, force)`` cut to its L = N*/n rows on the group's
    device.  With n > 1 and a halo plan the model runs the halo operator
    (the next rank's first G mask rows come over once, here); without a
    plan, or with ``CIVIWAVE_GENERAL_HALO=0``, the all-gather form; one
    rank keeps the single-device operator.  A collective: every rank of
    the group calls it."""
    from .collectives import ppermute
    from .general_halo import HALO_ARRAYS

    if group.two_d:
        raise ShardError("the general path shards over a 1-D group",
                         [f"npx={group.npx}", f"npy={group.npy}"])
    n, s, device = group.size, group.rank, group.device
    _check_general(model, n)
    model = _to_device(model, device)
    plan = general_plan(model, n) if n > 1 and _halo_enabled() else None
    if plan is None:
        window = None
        if n > 1:
            window = dataclasses.replace(
                model, damp_blocks=None, damp_factor=None,
                **{k: None for k in HALO_ARRAYS}, halo_block="")
        local = _row_shard(model, s, n, window)
    else:
        L, G = int(plan["halo_local_nodes"]), int(plan["halo_ghost"])
        bc_ghost = model.bc_mask[s * L:s * L + G]
        if G:
            bc_ghost = ppermute(bc_ghost.to(torch.uint8),
                                group.pairs(0, -1)).bool()
        local = _halo_shard(model, plan, s, bc_ghost, device)
    local = dataclasses.replace(local, shard_group=group)
    fields = (state.displacement, state.velocity, state.acceleration,
              state.warm_x)
    return (local, SimState(*(local.own_rows(v).to(device) for v in fields)),
            local.own_rows(external_force).to(device))


def _to_device(model: PackedModel, device) -> PackedModel:
    """``model`` with every tensor field on ``device``."""
    device = torch.device(device)
    changes = {
        f.name: getattr(model, f.name).to(device)
        for f in dataclasses.fields(model)
        if isinstance(getattr(model, f.name), torch.Tensor)
    }
    return dataclasses.replace(model, **changes)


def local_general_shards(model: PackedModel, n: int):
    """Every shard of an ``n``-way halo cut of ``model`` in one process,
    without a group, each with its next shard's mask rows cut from the
    global mask: what :func:`shard_general` gives each rank (for checks of
    the shard operator).  Raises ShardError where no plan holds."""
    _check_general(model, n)
    plan = general_plan(model, n)
    if plan is None:
        raise ShardError("no halo plan holds for this model",
                         [f"ranks={n}"])
    L, G = int(plan["halo_local_nodes"]), int(plan["halo_ghost"])
    mask = torch.cat([model.bc_mask, model.bc_mask.new_zeros((G, 3))])
    return [
        _halo_shard(model, plan, s, mask[(s + 1) * L:(s + 1) * L + G],
                    model.device)
        for s in range(n)
    ]
