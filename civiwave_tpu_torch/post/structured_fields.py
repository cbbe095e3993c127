"""Derived fields on the device and O(1) probe sampling for structured grids.

Port of :mod:`civiwave_tpu.post.structured_fields`.  On the uniform grid the
host derived-field math (``post/derived.py``) collapses: every Gauss point
carries the volume V/8, so the volume-weighted element average is the
strain of the MEAN gradient table, and the node average is the uniform
mean over incident cells (a corner scatter, the pattern of the mass
assembly).  :func:`compute_structured_derived` runs it in torch on the
model's device in CSG layout (the reference runs it in XLA, with no Pallas
kernel, so torch ops are its counterpart); the corner scatter is eight
in-place slice adds into preallocated accumulators, and the incident-cell
count is one grid built once per grid shape.  The host sees (E, 6)/(N, 6)
rows only on VTU frames (:func:`derived_to_host`).

Probe logging must not pull whole fields at 50M DOF: probes are fixed node
ids, so :func:`probe_samples` gathers each probe's u/v/a and the 3x3x3
displacement window around it into one small tensor and moves it to the
host in one transfer per frame; :func:`probe_derived_host` evaluates the
<= 8 incident-cell strains from the window on the host, the same incident-
cell mean the full node average computes.

Both read each cell's own material from ``lam_grid``/``mu_grid`` (one
value on every live cell of a homogeneous grid, per-cell values on a
heterogeneous one); the probes gather their incident cells' values in one
small transfer per call.  Dead +Y rows (``pad_rows``) are stripped before
the node rows are flattened, as ``to_nodal`` does.

On a shard (``parallel.sharding.shard_structured``; the reference's arrays
are global under GSPMD, so its functions serve a shard unchanged) both are
collectives, called by every rank in the same order:

* the derived fields of a shard are its own: the element fields of the
  cells it owns (a cell lives with its low-corner node, as in G3) and the
  node fields of its nodes.  u's ghost planes (and, on a tile, rows) are
  exchanged once per call (2 or 4 counted ``ppermute``), so a node of the
  block's first plane averages the cells of the plane below it, and each
  node sums the same cells in the same order as on the whole grid: the
  fields equal the unsharded ones bit for bit.  :func:`gather_derived`
  brings them to rank 0;
* probes: every rank samples the entries of the probes' rows, windows and
  incident cells that it owns, and one counted ``collectives.gather`` per
  frame brings them to rank 0, which picks each entry from its owner (a
  window across a block's edge included), so a frame without a VTU moves
  O(1) values and no field.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..mesh.structured import CORNERS, StructuredModel
from ..ops.structured import _element_tables, corner_views
from ..utils import profiling
from ..utils.errors import ProbeError
from .derived import DerivedFieldSet


@lru_cache(maxsize=32)
def _mean_grads(spacing: Tuple[float, float, float]) -> np.ndarray:
    """Volume-weighted mean Gauss gradient table (8 corners, 3): the
    element's volume-averaged strain is the strain of this table."""
    grads, gp_vol = _element_tables(spacing)
    return np.einsum("g,gla->la", gp_vol, grads) / gp_vol.sum()


def _von_mises_into(out: torch.Tensor, s) -> torch.Tensor:
    """sqrt(max(0.5 sum (s_i - s_j)^2 + 3 sum tau^2, 0)) written into
    ``out``."""
    energy = (s[0] - s[1]).square_()
    energy += (s[1] - s[2]).square_()
    energy += (s[2] - s[0]).square_()
    energy *= 0.5
    shear = s[3].square() + s[4].square() + s[5].square()
    energy += 3.0 * shear
    return torch.sqrt(energy.clamp_(min=0.0), out=out)


@lru_cache(maxsize=2)
def _incident_cells(shape, cells, device: str) -> torch.Tensor:
    """(X, Y, Z) f32 count of cells incident to each node, at least 1 (dead
    pad nodes and rows have none), for one grid shape; built once."""
    nx, ny, nz = cells
    count = torch.zeros(shape, dtype=torch.float32, device=device)
    for (di, dj, dk) in CORNERS:
        count[di : di + nx, dj : dj + ny, dk : dk + nz] += 1.0
    return count.clamp_(min=1.0)


def _cell_fields(model: StructuredModel, views, lam, mu, cells):
    """(strain (6, *cells), stress (6, *cells), von Mises ``cells``) of the
    cells whose eight corner views of u are ``views``, materials ``lam``,
    ``mu`` (broadcastable to ``cells``)."""
    mg = _mean_grads(tuple(model.spacing))
    f32 = torch.float32
    dev = views[0].device

    # g[a][b] = du_b/dx_a from the mean gradient table, f32 scale per term
    g = [[None] * 3 for _ in range(3)]
    for a in range(3):
        for b in range(3):
            acc = None
            for l in range(8):
                w = float(np.float32(mg[l, a]))
                if w == 0.0:
                    continue
                if acc is None:
                    acc = views[l][b] * w
                else:
                    acc += views[l][b] * w
            g[a][b] = acc if acc is not None else torch.zeros(
                cells, dtype=f32, device=dev
            )
    elem_strain = torch.empty((6, *cells), dtype=f32, device=dev)
    elem_strain[0], elem_strain[1], elem_strain[2] = g[0][0], g[1][1], g[2][2]
    torch.add(g[1][0], g[0][1], out=elem_strain[3])
    torch.add(g[2][1], g[1][2], out=elem_strain[4])
    torch.add(g[2][0], g[0][2], out=elem_strain[5])
    del g

    # isotropic stress: normal = lam tr + 2 mu eps, shear = mu gamma
    tr = elem_strain[0] + elem_strain[1] + elem_strain[2]
    lam_tr = lam * tr
    two_mu = 2.0 * mu
    elem_stress = torch.empty_like(elem_strain)
    for i in range(3):
        torch.add(lam_tr, two_mu * elem_strain[i], out=elem_stress[i])
    for i in range(3, 6):
        torch.mul(mu, elem_strain[i], out=elem_stress[i])
    del tr, lam_tr, two_mu
    elem_vm = _von_mises_into(
        torch.empty(cells, dtype=f32, device=dev), elem_stress
    )
    return elem_strain, elem_stress, elem_vm


def compute_structured_derived(model: StructuredModel, u_csg: torch.Tensor):
    """Element and node derived fields on the model's device.

    Returns (elem_strain, elem_stress, elem_vm, node_strain, node_stress,
    node_vm): element grids (6, nx, ny, nz)/(nx, ny, nz), node grids (6, X,
    Y, Z)/(X, Y, Z) in CSG layout, f32.  Strain is Voigt with engineering
    shear [xx, yy, zz, xy, yz, xz]; stress the isotropic D . eps.  On a
    shard (a collective) the element grids are (6, Xl, Yl, nz)/(Xl, Yl,
    nz), each cell at its low-corner node of the block (zero where that
    node has no live cell), and the node grids the block's.
    """
    if model.shard_group is not None:
        return _shard_derived(model, u_csg)
    nx, ny, nz = model.nx, model.ny, model.nz
    f32 = torch.float32
    dev = u_csg.device
    elem_strain, elem_stress, elem_vm = _cell_fields(
        model, corner_views(model, u_csg), model.lam_cells, model.mu_cells,
        (nx, ny, nz))

    # node average: the uniform mean over incident cells
    count = _incident_cells(
        tuple(model.grid_shape), (nx, ny, nz), str(dev)
    )
    node_strain = torch.zeros((6,) + tuple(model.grid_shape), dtype=f32, device=dev)
    node_stress = torch.zeros_like(node_strain)
    for acc, elem in ((node_strain, elem_strain), (node_stress, elem_stress)):
        for view in corner_views(model, acc):
            view += elem
        acc /= count
    node_vm = _von_mises_into(
        torch.empty(tuple(model.grid_shape), dtype=f32, device=dev), node_stress
    )
    return elem_strain, elem_stress, elem_vm, node_strain, node_stress, node_vm


def _shard_cells(model: StructuredModel):
    """(lam, mu, live) of the cells with a corner on a shard's node block,
    (X + 1, Y + 1, nz) for a (X, Y, Z) block, cell (ci, cj) at [ci + 1,
    cj + 1]: lam and mu zero off the live grid, ``live`` (X + 1, Y + 1, 1)
    bool.  A heterogeneous shard's come from its ghost cells
    (``ops.structured.extended_cells``); a homogeneous one's are its one
    material."""
    from ..ops.structured import extended_cells

    X, Y, _ = model.grid_shape
    dev = model.device
    gx = torch.arange(-1, X, device=dev) + model.x0
    gy = torch.arange(-1, Y, device=dev) + model.y0
    live = (((gx >= 0) & (gx < model.nx))[:, None, None]
            & ((gy >= 0) & (gy < model.ny))[None, :, None])
    if model.homogeneous:
        lam, mu = (torch.where(live, value, 0.0).to(torch.float32)
                   for value in (model.lam0, model.mu0))
    else:
        lam, mu = extended_cells(model)
    return lam, mu, live


def _shard_derived(model: StructuredModel, u: torch.Tensor):
    """:func:`compute_structured_derived` of a shard: u's ghosts exchanged
    once, the cells of the extended block, the block's nodes averaged."""
    from ..ops.structured_sharded import exchange_ghosts

    group = model.shard_group
    X, Y, Z = model.grid_shape
    nz = model.nz
    ghosts = exchange_ghosts(u, group)
    ext = u.new_zeros((3, X + 2, Y + 2, Z))
    ext[:, 1:-1, 1:-1] = u
    rows = slice(None) if group.two_d else slice(1, -1)
    ext[:, 0, rows] = ghosts.x_lo
    ext[:, -1, rows] = ghosts.x_hi
    if group.two_d:
        ext[:, 1:-1, 0] = ghosts.y_lo
        ext[:, 1:-1, -1] = ghosts.y_hi
    lam, mu, live = _shard_cells(model)
    cells = (X + 1, Y + 1, nz)
    views = [ext[..., di:di + X + 1, dj:dj + Y + 1, dk:dk + nz]
             for (di, dj, dk) in CORNERS]
    elem = [torch.where(live, f, 0.0)
            for f in _cell_fields(model, views, lam, mu, cells)]
    del views, ext

    # the block's nodes: node (i, j, k) takes cell (i - di, j - dj, k - dk)
    # at [i - di + 1, j - dj + 1] of the extended cells, in CORNERS order
    live_f = live.to(torch.float32).expand(cells)
    count = torch.zeros((X, Y, Z), dtype=torch.float32, device=u.device)
    node_strain = torch.zeros((6, X, Y, Z), dtype=torch.float32, device=u.device)
    node_stress = torch.zeros_like(node_strain)
    for di, dj, dk in CORNERS:
        block = (slice(1 - di, 1 - di + X), slice(1 - dj, 1 - dj + Y))
        count[..., dk:dk + nz] += live_f[block]
        node_strain[..., dk:dk + nz] += elem[0][(slice(None), *block)]
        node_stress[..., dk:dk + nz] += elem[1][(slice(None), *block)]
    count.clamp_(min=1.0)
    node_strain /= count
    node_stress /= count
    node_vm = _von_mises_into(
        torch.empty((X, Y, Z), dtype=torch.float32, device=u.device),
        node_stress)
    own = (slice(1, None), slice(1, None))
    return (elem[0][(slice(None), *own)], elem[1][(slice(None), *own)],
            elem[2][own], node_strain, node_stress, node_vm)


def gather_derived(model: StructuredModel, device_fields, dst: int = 0):
    """A shard's :func:`compute_structured_derived` fields as the global
    grids the unsharded function returns (element grids (6, nx, ny, nz)),
    on rank ``dst`` (six counted gathers, a collective; None on the other
    ranks)."""
    from ..parallel.sharding import gather_structured

    group = model.shard_group
    out = [gather_structured(f, group, dst) for f in device_fields]
    if out[0] is None:
        return None
    live = (slice(0, model.nx), slice(0, model.ny))
    for e in (0, 1):
        out[e] = out[e][(slice(None), *live)]
    out[2] = out[2][live]
    return tuple(out)


def derived_to_host(model: StructuredModel, device_fields) -> DerivedFieldSet:
    """The device grids as the host (E, 6)/(N, 6) rows of the VTU writer and
    the probe logger (x-major element and node order).  The node grids lose
    their dead +Y rows before flattening and their +X pad planes after, as
    ``to_nodal`` does; the reference keeps the first N rows of the padded
    flattening, which interleaves dead rows when ``pad_rows > 0``."""
    elem_strain, elem_stress, elem_vm, node_strain, node_stress, node_vm = (
        device_fields
    )
    n = model.node_count
    ys = model.ny + 1

    def rows6(a):
        return profiling.to_host(a.permute(1, 2, 3, 0).reshape(-1, 6)).numpy()

    return DerivedFieldSet(
        element_strain=rows6(elem_strain),
        element_stress=rows6(elem_stress),
        element_von_mises=profiling.to_host(elem_vm.reshape(-1)).numpy(),
        node_strain=rows6(node_strain[:, :, :ys])[:n],
        node_stress=rows6(node_stress[:, :, :ys])[:n],
        node_von_mises=profiling.to_host(
            node_vm[:, :ys].reshape(-1)[:n]).numpy(),
    )


# ---------------------------------------------------------------------------
# O(1) probe sampling
# ---------------------------------------------------------------------------


def _probe_coords(cells, probe: int) -> Tuple[int, int, int]:
    """(i, j, k) of a node id in the x-major order of the real grid of
    ``cells`` = (nx, ny, nz)."""
    ys, zs = cells[1] + 1, cells[2] + 1
    return probe // (ys * zs), (probe // zs) % ys, probe % zs


def _window_bounds(cells, i: int, j: int, k: int):
    """The 3x3x3 node window around (i, j, k), clipped at the real grid of
    ``cells`` = (nx, ny, nz)."""
    extents = tuple(c + 1 for c in cells)
    lo = tuple(max(c - 1, 0) for c in (i, j, k))
    hi = tuple(min(c + 2, e) for c, e in zip((i, j, k), extents))
    return lo, hi


def _probe_index(grid_shape, cells, probes: Tuple[int, ...]):
    """Host flat indices into a CSG vector of ``grid_shape``: every probe's
    node components (u, v and a read these), the probes' windows (u only)
    and the window shapes."""
    X, Y, Z = grid_shape
    plane = X * Y * Z
    comps = np.arange(3, dtype=np.int64)[:, None, None, None] * plane
    node_idx, window_idx, shapes = [], [], []
    for p in probes:
        i, j, k = _probe_coords(cells, p)
        node_idx.append(comps.reshape(3) + (i * Y + j) * Z + k)
        lo, hi = _window_bounds(cells, i, j, k)
        ii, jj, kk = np.meshgrid(
            *(np.arange(a, b, dtype=np.int64) for a, b in zip(lo, hi)),
            indexing="ij",
        )
        window_idx.append((comps + ((ii * Y + jj) * Z + kk)[None]).reshape(-1))
        shapes.append((3,) + tuple(b - a for a, b in zip(lo, hi)))
    return np.concatenate(node_idx), np.concatenate(window_idx), shapes


@lru_cache(maxsize=8)
def _probe_plan(grid_shape, cells, probes: Tuple[int, ...], device: str):
    """:func:`_probe_index` as tensors on ``device``: (node, node then
    windows, shapes)."""
    node, window, shapes = _probe_index(grid_shape, cells, probes)
    node = torch.as_tensor(node, device=device)
    window = torch.as_tensor(window, device=device)
    return node, torch.cat([node, window]), shapes


def _incident(cells, probes):
    """Per probe, its live incident cells (ci, cj, ck) of the grid of
    ``cells`` = (nx, ny, nz), in the order the node average takes them."""
    nx, ny, nz = cells
    out = []
    for p in probes:
        i, j, k = _probe_coords(cells, int(p))
        out.append([
            (ci, cj, ck)
            for ci in (i - 1, i) for cj in (j - 1, j) for ck in (k - 1, k)
            if 0 <= ci < nx and 0 <= cj < ny and 0 <= ck < nz
        ])
    return out


def _check_probes(model, probes):
    for p in probes:
        if not 0 <= p < model.node_count:
            raise ProbeError("probe index out of range", [str(p)])


def _split_samples(host, shapes, n_p):
    """(kinematics (P, 3, 3), windows) of a flat sample vector laid out as
    u at the nodes, u's windows, v, a (then anything after, ignored)."""
    windows_size = sum(int(np.prod(s)) for s in shapes)
    u_node = host[:3 * n_p]
    windows_flat = host[3 * n_p:3 * n_p + windows_size]
    rest = host[3 * n_p + windows_size:]
    v_node, a_node = rest[:3 * n_p], rest[3 * n_p:6 * n_p]
    kin = np.stack(
        [u_node.reshape(n_p, 3), v_node.reshape(n_p, 3), a_node.reshape(n_p, 3)],
        axis=1,
    )
    windows, start = [], 0
    for shape in shapes:
        size = int(np.prod(shape))
        windows.append(windows_flat[start : start + size].reshape(shape))
        start += size
    return kin, windows


def probe_samples(model: StructuredModel, state, probes: Sequence[int]):
    """Per probe: its (u, v, a) rows and the 3x3x3 displacement window
    around its node (clipped at the grid's edges), gathered on the device
    into one small tensor and moved to the host in one transfer.

    Returns (kinematics (P, 3 kin, 3 comp) f32 numpy, [window (3, wx, wy,
    wz) f32 numpy per probe]).  A probe id outside the mesh raises
    ProbeError before anything is read.  On a shard a collective (one
    gather); rank 0 gets the result, the other ranks None."""
    probes = tuple(int(p) for p in probes)
    if not probes:
        return np.zeros((0, 3, 3), np.float32), []
    _check_probes(model, probes)
    if model.shard_group is not None:
        got = _shard_probe_gather(model, state, probes)
        return None if got is None else got[:2]
    node, u_idx, shapes = _probe_plan(
        tuple(model.grid_shape), (model.nx, model.ny, model.nz), probes,
        str(model.device),
    )
    host = profiling.to_host(torch.cat([
        state.displacement.reshape(-1)[u_idx],
        state.velocity.reshape(-1)[node],
        state.acceleration.reshape(-1)[node],
    ])).numpy()
    return _split_samples(host, shapes, len(probes))


@lru_cache(maxsize=8)
def _shard_probe_plan(global_shape, cells, probes: Tuple[int, ...], npx: int,
                      npy: int, rank: int, cell_y: int, device: str):
    """What rank ``rank`` of an (npx, npy) cut samples for the probes: per
    source (u, v, a, lam, mu) the local flat indices of the entries it
    owns (0 elsewhere), as tensors on ``device``, with the mask of its
    entries, every entry's owner (host) and the window shapes; the
    entries are laid out as :func:`probe_samples` reads them, then the
    incident cells' lam and mu.  ``cell_y``: the rank's own cell rows."""
    X, Y, Z = global_shape
    xl, yl = X // npx, Y // npy
    node, window, shapes = _probe_index(global_shape, cells, probes)

    def nodes(flat):
        c, i, j, k = np.unravel_index(flat, (3, X, Y, Z))
        px, py = i // xl, j // yl
        return px * npy + py, ((c * xl + i - px * xl) * yl + j - py * yl) * Z + k

    ci, cj, ck = (np.array(a, np.int64).reshape(-1) for a in zip(
        *[c for per in _incident(cells, probes) for c in per]))
    cell_px, cell_py = ci // xl, cj // yl
    cell = (cell_px * npy + cell_py,
            ((ci - cell_px * xl) * cell_y + cj - cell_py * yl) * cells[2] + ck)
    parts = [nodes(np.concatenate([node, window])), nodes(node), nodes(node),
             cell, cell]
    owner = np.concatenate([o for o, _ in parts])
    local = [torch.as_tensor(np.where(o == rank, at, 0), device=device)
             for o, at in parts]
    mine = torch.as_tensor(owner == rank, device=device)
    return local, mine, owner, shapes


def _shard_probe_gather(model: StructuredModel, state, probes):
    """(kinematics, windows, materials (2, cells)) on rank 0 of a shard,
    None elsewhere: every rank's owned entries in one gather."""
    from ..parallel import collectives

    group = model.shard_group
    local, mine, owner, shapes = _shard_probe_plan(
        tuple(model.global_grid_shape), (model.nx, model.ny, model.nz),
        probes, group.npx, group.npy, group.rank, model.lam_grid.shape[1],
        str(model.device))
    sources = (state.displacement, state.velocity, state.acceleration,
               model.lam_grid, model.mu_grid)
    f64 = torch.float64
    buffer = torch.cat([
        src.reshape(-1)[at].to(f64) if src.numel()
        else torch.zeros(at.shape, dtype=f64, device=at.device)
        for src, at in zip(sources, local)])
    parts = collectives.gather(torch.where(mine, buffer, 0.0), 0)
    if parts is None:
        return None
    host = profiling.to_host(torch.stack(parts)).numpy()
    host = host[owner, np.arange(owner.size)]
    n_p = len(probes)
    kin, windows = _split_samples(host, shapes, n_p)
    dtype = np.float64 if state.displacement.dtype == f64 else np.float32
    n_cells = sum(len(c) for c in _incident(
        (model.nx, model.ny, model.nz), probes))
    materials = host[host.size - 2 * n_cells:].reshape(2, n_cells)
    return (kin.astype(dtype), [w.astype(dtype) for w in windows], materials)


def probe_rows(model: StructuredModel, state, probes: Sequence[int]):
    """(kinematics, [(strain6, stress6, von_mises)] per probe) for the
    probe logger: :func:`probe_samples` then :func:`probe_derived_host`.
    On a shard a collective (one gather per call); rank 0 gets the rows,
    the other ranks None."""
    probes = tuple(int(p) for p in probes)
    if model.shard_group is None or not probes:
        kin, windows = probe_samples(model, state, probes)
        return kin, probe_derived_host(model, probes, windows)
    _check_probes(model, probes)
    got = _shard_probe_gather(model, state, probes)
    if got is None:
        return None
    kin, windows, materials = got
    return kin, probe_derived_host(model, probes, windows, materials)


def probe_derived_host(
    model: StructuredModel, probes: Sequence[int], windows, materials=None,
) -> List[Tuple[np.ndarray, np.ndarray, float]]:
    """(strain6, stress6, von_mises) per probe from its displacement window
    (f64 on the host): the mean over the probe's incident cells, the value
    of the full node average at that node.  ``materials``: the incident
    cells' (lam, mu) rows, (2, cells) in :func:`_incident` order; by
    default gathered from the model's cell grids (an unsharded model's;
    a shard's come from :func:`probe_rows`)."""
    mg = _mean_grads(tuple(model.spacing))
    nx, ny, nz = model.nx, model.ny, model.nz
    incident = _incident((nx, ny, nz), probes)
    if materials is None:
        if model.shard_group is not None:
            raise ValueError("a shard's probe materials come with its "
                             "samples: call probe_rows")
        # every incident cell's lam and mu, gathered on the device at once
        cell_y = model.lam_grid.shape[1]
        flat = [(ci * cell_y + cj) * nz + ck for cells in incident
                for ci, cj, ck in cells]
        index = profiling.from_host(flat, model.device, torch.int64)
        materials = profiling.to_host(torch.stack([
            model.lam_grid.reshape(-1)[index], model.mu_grid.reshape(-1)[index],
        ])).numpy()
    materials = np.asarray(materials, np.float64)
    out, start = [], 0
    for p, w, cells in zip(probes, windows, incident):
        i, j, k = _probe_coords((nx, ny, nz), int(p))
        lo, _ = _window_bounds((nx, ny, nz), i, j, k)
        w = np.asarray(w, np.float64)  # (3, wx, wy, wz)
        strain_sum = np.zeros(6)
        stress_sum = np.zeros(6)
        n_cells = 0
        for ci, cj, ck in cells:
            lam, mu = materials[:, start + n_cells]
            oi, oj, ok = ci - lo[0], cj - lo[1], ck - lo[2]
            g = np.zeros((3, 3))
            for l, (di, dj, dk) in enumerate(CORNERS):
                ul = w[:, oi + di, oj + dj, ok + dk]
                g += np.outer(mg[l], ul)  # g[a, b] = du_b/dx_a
            strain = np.array([
                g[0, 0], g[1, 1], g[2, 2],
                g[1, 0] + g[0, 1], g[2, 1] + g[1, 2],
                g[2, 0] + g[0, 2],
            ])
            tr = strain[:3].sum()
            stress = np.concatenate([
                lam * tr + 2.0 * mu * strain[:3],
                mu * strain[3:],
            ])
            strain_sum += strain
            stress_sum += stress
            n_cells += 1
        start += n_cells
        inv = 1.0 / max(n_cells, 1)
        s = stress_sum * inv
        vm = float(np.sqrt(max(
            0.5 * ((s[0] - s[1]) ** 2 + (s[1] - s[2]) ** 2
                   + (s[2] - s[0]) ** 2)
            + 3.0 * (s[3] ** 2 + s[4] ** 2 + s[5] ** 2), 0.0,
        )))
        out.append((
            (strain_sum * inv).astype(np.float32), s.astype(np.float32), vm
        ))
    return out
