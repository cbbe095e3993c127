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
  that exchange out of its PCG body).
* :func:`shard_simulation` does the same to a whole
  ``runner.Simulation`` (its force schedule included) and gives it a
  stepper over the shard: the one way the launcher, ``chip_smoke.py`` and
  the tests build a sharded run.
* :func:`gather_structured` reassembles a global ``(3, X, Y, Z)`` vector
  for host-facing output (the stepper's ``displacement()`` and the like
  call it on a shard).

Ranks are ordered X-major: rank ``px * npy + py`` holds tile ``(px, py)``,
as the reference's 2-D mesh lays X slowest.  The general path's sharding
(the reference's ``shard_simulation`` of a packed model and its
``model_shardings``) is not ported (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.distributed as dist

from ..mesh.pack import SimState
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
    mask ghosts: every node-grid field cut to the tile (the material cell
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
    ``two_d`` False), each with its mask ghosts cut from the global mask:
    what :func:`shard_structured` gives each rank, in one process and
    without a group (for checks of the shard operator)."""
    from ..ops.structured_sharded import cut_ghosts

    tiles = []
    for px in range(group_shape[0]):
        for py in range(group_shape[1]):
            local = local_model(model, group_shape, (px, py))
            bc = cut_ghosts(model.bc_mask, local.x0, local.y0,
                            *local.local_extent, two_d)
            tiles.append(dataclasses.replace(local, bc_ghosts=bc))
    return tiles


def shard_structured(model, state: SimState, external_force, group: ShardGroup):
    """This rank's shard of a StructuredModel simulation: ``(model, state,
    force)`` cut to its slab (1-D group) or tile (2-D group) on the group's
    device, the model carrying the group, its offsets and the mask's ghost
    planes and rows.  A multigrid model's shard falls back to block-Jacobi
    with a note on stderr.  A collective: every rank of the group calls
    it."""
    from ..ops.structured_sharded import exchange_ghosts

    if model.absorb_faces:
        raise NotImplementedError(
            "absorbing faces on a sharded structured model are not ported "
            "yet (ROADMAP A11)"
        )
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
    local = dataclasses.replace(local, shard_group=group, bc_ghosts=bc_ghosts)
    fields = (state.displacement, state.velocity, state.acceleration,
              state.warm_x)
    return local, SimState(*(cut(v) for v in fields)), cut(external_force)


def shard_simulation(sim, group: ShardGroup):
    """This rank's shard of ``sim``, a ``runner.Simulation`` on the
    structured route whose grid divides the group (build it with
    ``build_simulation(..., pad_x_multiple=npx, pad_y_multiple=npy)``):
    its model, state and force cut by :func:`shard_structured`, each part
    of its force schedule cut to the same block, and a new
    ``NewmarkStepper`` over them with the old one's settings, dt, time and
    frame.  A collective: every rank of the group calls it.  A simulation
    built with an output root raises NotImplementedError (ROADMAP A11)."""
    from ..mesh.structured_config import StructuredForceSchedule
    from ..solver.stepper import NewmarkStepper

    if sim.force_schedule is None:
        raise NotImplementedError(
            "sharding the general gather path is not ported yet (ROADMAP A11)"
        )
    if sim.output is not None:
        raise NotImplementedError(
            "output of a sharded simulation is not ported yet (ROADMAP A11)"
        )
    old = sim.stepper
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
    return dataclasses.replace(sim, model=model, stepper=stepper,
                               force_schedule=schedule)


def gather_structured(vector: torch.Tensor, group: ShardGroup) -> torch.Tensor:
    """The global ``(3, X, Y, Z)`` vector from every rank's block (an
    all-gather, on the group's device; a collective)."""
    if group.size == 1:
        return vector
    parts = [torch.empty_like(vector) for _ in range(group.size)]
    dist.all_gather(parts, vector.contiguous())
    rows = [
        torch.cat(parts[px * group.npy:(px + 1) * group.npy], dim=2)
        for px in range(group.npx)
    ]
    return torch.cat(rows, dim=1)
