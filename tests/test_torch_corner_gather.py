"""G3 (``corner_gather``, the heterogeneous grid's operator) on the CPU: its
packed tables, its launch geometry and its sweep, emulated in numpy.

* The packed (48, 24) [A; B] (``ops.cuda.corner_gather.packed_tables``)
  rebuilds the operator in torch ops (``chip_smoke.g3_composition``, the
  yardstick phase 29 times: the 8 corner views, one product with the
  table, lam/mu scaling, 8 slice adds): against the port's plain version
  (``heterogeneous_stiffness`` inside ``apply_keff_structured_plain``) and
  the reference's ``_apply_heterogeneous_stiffness`` (through its
  ``apply_keff``) on ``chip_smoke.G3_SHAPES``, 1e-12 of max|ref| in f64 and
  1e-5 in f32; its DMMA fragment order holds the table lane by lane.
* The geometry (``plane_sweep.corner_gather_geometry`` and
  ``corner_gather_cells``): every node of the grid is written by one block
  and plane, and every (node, incident cell) pair is gathered once, the
  cell inside the block's computed cells, on those grids and on 256^3;
  two blocks fit in an SM's shared memory in both instances.
* The kernel's block loop in numpy (tiles, the two node-plane ring, the
  f32 halves, the DMMA lanes' A, B and D fragments, the carry between
  planes, the envelope) against the plain version: 1e-12 of max|ref| in
  f64, 1e-5 in f32 (the emulation sums in f64; its point is the
  indexing).  The same loop over a shard's plane range, its node rows
  routed as the kernel's ``row_source`` routes them (the block, X ghost
  planes, Y ghost rows) and its cells as ``stage_cells`` reads them (the
  block, the ghost cell plane and row, liveness at global coordinates):
  every node of the range written once, and ``G3_SHAPES`` cut into 2
  slabs and 2 x 2 tiles, in one launch and in the overlap split's three
  ranges, gathered, equal to the whole grid's emulation exactly.

The CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_kernels_cuda.py -k corner_gather``, ``chip_smoke.py``
phase 29).
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from chip_smoke import G3_SHAPES, g3_composition, hetero_cells
from civiwave_tpu.mesh import structured as jstructured
from civiwave_tpu.physics import materials as jmaterials
from civiwave_tpu_torch.mesh import structured as tstructured
from civiwave_tpu_torch.mesh.structured import CORNERS
from civiwave_tpu_torch.ops import structured as tops
from civiwave_tpu_torch.ops.cuda import corner_gather as g3
from civiwave_tpu_torch.ops.cuda import plane_sweep
from civiwave_tpu_torch.ops.structured_sharded import cut_ghosts
from civiwave_tpu_torch.parallel import sharding
from civiwave_tpu_torch.physics import materials as tmaterials
from civiwave_tpu_torch.utils.synthetic import cantilever_config

torch.set_num_threads(2)

CPU = torch.device("cpu")
SS, MF = np.float32(1.0000727), np.float32(4.0003636e6)
TOL = {np.float32: 1e-5, np.float64: 1e-12}  # of max|ref|
TRACTION = (0.0, 0.0, -1.0e6)
SM_SMEM = 233_472  # shared memory of one H100 SM; a block takes 1 KB more
DTYPES = pytest.mark.parametrize("dtype", [np.float32, np.float64],
                                 ids=["f32", "f64"])


def build_pair(case, **pads):
    """(jax model, port model) of G3_SHAPES[case] with the same cells
    (``pads``: build options that override the case's)."""
    dims, kw = G3_SHAPES[case]
    mat = cantilever_config().materials[0]
    lam, mu = hetero_cells(dims)
    kw = dict(traction=TRACTION, lam_grid=lam, mu_grid=mu, **{**kw, **pads})
    jm, _ = jstructured.build_structured_model(
        *dims, jmaterials.make_properties(mat), mat.density, **kw)
    tm, _ = tstructured.build_structured_model(
        *dims, tmaterials.make_properties(mat), mat.density, device=CPU, **kw)
    assert not tm.homogeneous and not jm.homogeneous
    return jm, tm


def vector(model, seed, dtype):
    return np.random.default_rng(seed).standard_normal(
        model.vector_shape).astype(dtype)


def scalars(dtype):
    return (SS, MF) if dtype == np.float32 else (np.float64(SS), np.float64(MF))


def assert_close(got, ref, rel, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), f"{name}: {err:.3e}"


# --- the packed tables -------------------------------------------------------


@DTYPES
@pytest.mark.parametrize("case", sorted(G3_SHAPES))
def test_packed_tables_rebuild_the_operator(case, dtype):
    jm, tm = build_pair(case)
    x = vector(tm, seed=31, dtype=dtype)
    ss, mf = scalars(dtype)
    composed = g3_composition(tm, torch.as_tensor(x), ss, mf).numpy()
    assert composed.dtype == dtype
    plain = tops.apply_keff_structured_plain(tm, torch.as_tensor(x), ss, mf)
    reference = np.asarray(jm.apply_keff(jnp.asarray(x), ss, mf))
    assert_close(composed, plain.numpy(), TOL[dtype], "plain")
    assert_close(composed, reference, TOL[dtype], "reference")
    bc = tm.bc_mask.numpy()
    np.testing.assert_array_equal(composed[bc], x[bc])


def test_packed_tables_order_and_fragments():
    """Row (A/B) * 24 + b * 8 + l and column c * 8 + m hold
    pair_tables[A/B][l][b][m][c]; f32 is the f64 table rounded; fragment
    [mt][ks][lane] is row 8 mt + lane // 4, column 4 ks + lane % 4 (the
    A fragment of mma.sync m8n8k4), and kernel_tables hands each instance
    its form."""
    spacing = (0.02, 0.03, 0.05)
    pair = g3.pair_tables(spacing, torch.float64)
    packed = g3.packed_tables(spacing, torch.float64)
    assert packed.shape == (48, 24) and packed.dtype == np.float64
    for ab, b, l, c, m in itertools.product(range(2), range(3), range(8),
                                            range(3), range(8)):
        assert packed[ab * 24 + b * 8 + l, c * 8 + m] == pair[ab, l, b, m, c]
    np.testing.assert_array_equal(g3.packed_tables(spacing, torch.float32),
                                  packed.astype(np.float32))
    frags = g3.dmma_fragments(packed)
    assert frags.shape == (6, 6, 32)
    for mt, ks, lane in itertools.product(range(6), range(6), range(32)):
        assert frags[mt, ks, lane] == packed[8 * mt + lane // 4,
                                             4 * ks + lane % 4]
    np.testing.assert_array_equal(g3.kernel_tables(spacing, torch.float64),
                                  frags)
    np.testing.assert_array_equal(g3.kernel_tables(spacing, torch.float32),
                                  packed.astype(np.float32))
    assert g3.kernel_tables(spacing, torch.float32).size == 1152


# --- the launch geometry -----------------------------------------------------


def check_coverage(grid_shape, cells, elem):
    """Over every block of G3's geometry: each node is written once, and
    for each corner l each (node, cell) pair of the grid is gathered once,
    by the node's block, with the cell among the block's computed cells."""
    geom = plane_sweep.corner_gather_geometry(grid_shape, elem)
    nx, ny, nz = cells
    blocks = list(itertools.product(*(range(n) for n in geom.grid)))
    written = np.zeros(grid_shape, np.uint8)
    for block in blocks:
        (x0, x1), (y0, y1), (z0, z1) = geom.owned(block, grid_shape)
        assert x0 < x1 and y0 < y1 and z0 < z1
        written[x0:x1, y0:y1, z0:z1] += 1
    assert (written == 1).all()
    for l, (di, dj, dk) in enumerate(CORNERS):
        gathered = np.zeros(grid_shape, np.uint8)
        for block in blocks:
            owned = geom.owned(block, grid_shape)
            computed = plane_sweep.corner_gather_cells(geom, block, cells)
            # the owned nodes whose corner-l cell lies in the grid
            nodes = [(max(lo, d), min(hi, n + d))
                     for (lo, hi), d, n in zip(owned, (di, dj, dk), cells)]
            if any(lo >= hi for lo, hi in nodes):
                continue
            for (lo, hi), (clo, chi), d in zip(nodes, computed, (di, dj, dk)):
                assert clo <= lo - d and hi - d <= chi, (block, l)
            (a0, a1), (b0, b1), (c0, c1) = nodes
            gathered[a0:a1, b0:b1, c0:c1] += 1
        want = np.zeros(grid_shape, np.uint8)
        want[di:di + nx, dj:dj + ny, dk:dk + nz] = 1
        np.testing.assert_array_equal(gathered, want)


@pytest.mark.parametrize("elem", [4, 8])
@pytest.mark.parametrize("case", sorted(G3_SHAPES))
def test_geometry_covers_every_node_and_pair_once(case, elem):
    _, tm = build_pair(case)
    check_coverage(tm.grid_shape, (tm.nx, tm.ny, tm.nz), elem)


@pytest.mark.parametrize("elem", [4, 8])
def test_geometry_at_256_cubed(elem):
    """The 255^3-cell grid: 2,048 blocks, every node once, every pair once;
    two blocks fit in an SM; the cell tile fits two cells per thread (f32)
    and the force rows hold its 8-cell DMMA groups (f64)."""
    shape, cells = (256, 256, 256), (255, 255, 255)
    geom = plane_sweep.corner_gather_geometry(shape, elem)
    assert geom.grid == (8, 32, 8) and geom.blocks == 2048
    assert geom.smem_bytes == {4: 58_272, 8: 99_936}[elem]
    assert 2 * (geom.smem_bytes + 1024) <= SM_SMEM
    cy, cz = plane_sweep.G3_CELL_TILE
    assert geom.threads == 256 and cy * cz <= 2 * geom.threads
    assert 8 * -(-(cy * cz) // 8) <= plane_sweep.G3_FORCE_STRIDE
    check_coverage(shape, cells, elem)


# --- the sweep, emulated -----------------------------------------------------


def corner_x(l):
    return CORNERS[l][0]


def framed_nodes(model, x, ghosts):
    """x and the mask on the node block with a one-node frame along X and
    Y, each row taken from its source as the kernel's ``row_source`` picks
    it (the block; an X ghost plane, row jy + gy; a Y ghost row in 2-D;
    zero and free where there is none), and which rows have a source."""
    X, Y, Z = model.grid_shape
    bc = model.bc_mask.numpy()
    bg = model.bc_ghosts
    gy = int(ghosts is not None and ghosts.y_lo is not None)
    vals = np.zeros((3, X + 2, Y + 2, Z), x.dtype)
    mask = np.zeros((3, X + 2, Y + 2, Z), bool)
    has = np.zeros((X + 2, Y + 2), bool)

    def ghost(side, index):
        g = None if ghosts is None else getattr(ghosts, side)
        if g is None:
            return None
        m = None if bg is None else getattr(bg, side)
        return (np.asarray(g)[:, index],
                np.zeros((3, Z), bool) if m is None else m.numpy()[:, index])

    for jx, jy in itertools.product(range(-1, X + 1), range(-1, Y + 1)):
        if 0 <= jx < X and 0 <= jy < Y:
            row = x[:, jx, jy], bc[:, jx, jy]
        elif 0 <= jx < X:
            row = ghost("y_lo" if jy < 0 else "y_hi", jx) if gy else None
        elif 0 <= jy + gy < Y + 2 * gy:
            row = ghost("x_lo" if jx < 0 else "x_hi", jy + gy)
        else:
            row = None
        if row is not None:
            vals[:, jx + 1, jy + 1], mask[:, jx + 1, jy + 1] = row
            has[jx + 1, jy + 1] = True
    return vals, mask, has


def cell_source(model, ci, cj):
    """(lam, mu) rows (nz,) of cell (ci, cj) of the block as the kernel's
    ``stage_cells`` reads them, or None (zero): the block, the ghost cell
    plane (ci = -1, row cj + gy) or row (cj = -1); dead off the global
    grid and past the block's cell rows."""
    cg = model.cell_ghosts
    cell_y = model.lam_grid.shape[1]
    gy = 0 if cg is None or cg.y_lo is None else 1
    if not (0 <= model.x0 + ci < model.nx and 0 <= model.y0 + cj < model.ny
            and cj < cell_y):
        return None
    if ci < 0:
        if cg is None or cj < -gy:
            return None
        return cg.x_lo[:, cj + gy].numpy()
    if cj < 0:
        return None if not gy else cg.y_lo[:, ci].numpy()
    return np.stack([model.lam_grid[ci, cj].numpy(),
                     model.mu_grid[ci, cj].numpy()])


def emulate(model, x, ss, mf, ghosts=None, planes=None):
    """G3's block loop in numpy (f64 sums), with the kernel's indices,
    over planes ``planes`` (default all) of the model's block (a whole
    grid, or a shard with its x ``ghosts`` and the model's mask ghosts and
    ghost cells): the result the kernel computes up to rounding, NaN on the
    nodes it does not write.  Also returns how often each node was
    written."""
    x = np.asarray(x)
    f64 = x.dtype == np.float64
    X, Y, Z = model.grid_shape
    nz = model.nz
    geom = plane_sweep.corner_gather_geometry(model.grid_shape, x.itemsize,
                                              planes)
    ty, tz = geom.tile
    cy, cz = plane_sweep.G3_CELL_TILE
    vals, fixed_all, has = framed_nodes(model, x, ghosts)
    cg = model.cell_ghosts
    mass = model.mass_grid.numpy().astype(np.float64)
    table = g3.kernel_tables(model.spacing, torch.from_numpy(x).dtype)
    table = table.astype(np.float64)
    out = np.full_like(x, np.nan)
    written = np.zeros(model.grid_shape, np.uint8)

    def cells_live(ci):
        return (0 <= model.x0 + ci < model.nx
                and (ci >= 0 or (cg is not None and cg.x_lo is not None)))

    def node_plane(j, y0, z0):
        """The sanitized plane j, tile plus halo, and its mask."""
        san = np.zeros((3, ty + 2, tz + 2))
        fixed = np.zeros((3, ty + 2, tz + 2), bool)
        ys = slice(max(y0 - 1, -1), min(y0 + ty + 1, Y + 1))
        zs = slice(max(z0 - 1, 0), min(z0 + tz + 1, Z))
        hy = slice(ys.start - y0 + 1, ys.stop - y0 + 1)
        hz = slice(zs.start - z0 + 1, zs.stop - z0 + 1)
        fy = slice(ys.start + 1, ys.stop + 1)
        present = has[j + 1, fy][None, :, None]
        fixed[:, hy, hz] = fixed_all[:, j + 1, fy, zs] & present
        san[:, hy, hz] = np.where(fixed[:, hy, hz] | ~present, 0.0,
                                  vals[:, j + 1, fy, zs])
        return san, fixed

    def cell_plane(ci, y0, z0):
        lam, mu = np.zeros((cy, cz)), np.zeros((cy, cz))
        zs = slice(max(z0 - 1, 0), min(z0 + tz, nz))
        c = slice(zs.start - z0 + 1, zs.stop - z0 + 1)
        for r in range(cy):
            row = cell_source(model, ci, y0 - 1 + r)
            if row is not None:
                lam[r, c], mu[r, c] = row[0][zs], row[1][zs]
        return lam.reshape(-1), mu.reshape(-1)

    def corner_values(lo, hi):
        """u[c * 8 + m][n]: cell n's sanitized corner values."""
        u = np.empty((24, cy, cz))
        for c, m in itertools.product(range(3), range(8)):
            di, dj, dk = CORNERS[m]
            u[c * 8 + m] = (hi if di else lo)[c, dj:dj + cy, dk:dk + cz]
        return u.reshape(24, -1)

    def element_f32(lo, hi, lam, mu, lower):
        u = corner_values(lo, hi)
        force = np.full((24, cy * cz), np.nan)
        for b, l in itertools.product(range(3), range(8)):
            if corner_x(l) == 0 and not lower:
                continue  # the half the kernel skips
            row = b * 8 + l
            force[row] = lam * (table[row] @ u) + mu * (table[24 + row] @ u)
        return force

    def element_f64(lo, hi, lam, mu):
        """The DMMA groups, lane by lane: A = the fragments, B read from
        the node planes as each lane reads it, D laid out as the lanes
        hold it."""
        frag = table.reshape(6, 6, 32)
        groups = -(-(cy * cz) // 8)
        force = np.full((24, plane_sweep.G3_FORCE_STRIDE), np.nan)
        lane = np.arange(32)
        mc, l = lane & 3, lane >> 2
        lam = np.pad(lam, (0, plane_sweep.G3_FORCE_STRIDE - lam.size))
        mu = np.pad(mu, (0, plane_sweep.G3_FORCE_STRIDE - mu.size))
        for g in range(groups):
            nb = np.minimum(g * 8 + l, cy * cz - 1)
            rb, cb = nb // cz, nb % cz
            d = np.zeros((6, 8, 8))
            for ks in range(6):
                c, dk = ks >> 1, ks & 1
                bvals = np.array([
                    (hi if corner_x(m) else lo)[c, r + CORNERS[m][1], k + dk]
                    for m, r, k in zip(mc, rb, cb)])
                bmat = np.zeros((4, 8))
                bmat[mc, l] = bvals  # lane holds B[lane % 4][lane // 4]
                for mt in range(6):
                    amat = np.zeros((8, 4))
                    amat[l, mc] = frag[mt, ks]  # A[lane // 4][lane % 4]
                    d[mt] += amat @ bmat
            for i in range(2):  # lane holds D[lane // 4][2 (lane % 4) + i]
                nc = g * 8 + 2 * mc + i
                for b in range(3):
                    force[b * 8 + l, nc] = (lam[nc] * d[b][l, 2 * mc + i]
                                            + mu[nc] * d[b + 3][l, 2 * mc + i])
        return force[:, :cy * cz]

    for block in itertools.product(*(range(n) for n in geom.grid)):
        (x_lo, x_hi), (y0, y1), (z0, z1) = geom.owned(block, model.grid_shape)
        carry = np.zeros((3, ty, tz))
        lo, lo_fixed = node_plane(x_lo - 1, y0, z0)
        for j in range(x_lo, x_hi + 1):
            hi, hi_fixed = node_plane(j, y0, z0)
            ci, lower = j - 1, j - 1 >= x_lo
            done, nxt = carry.copy(), np.zeros((3, ty, tz))
            if cells_live(ci):
                lam, mu = cell_plane(ci, y0, z0)
                force = (element_f64(lo, hi, lam, mu) if f64 else
                         element_f32(lo, hi, lam, mu, lower)).reshape(3, 8, cy, cz)
                for l, (di, dj, dk) in enumerate(CORNERS):
                    f = force[:, l, 1 - dj:1 - dj + ty, 1 - dk:1 - dk + tz]
                    if di:
                        nxt += f
                    elif lower:
                        done += f
            if lower:
                n = (slice(None), ci, slice(y0, y1), slice(z0, z1))
                own = (slice(None), slice(0, y1 - y0), slice(0, z1 - z0))
                xs = lo[:, 1:ty + 1, 1:tz + 1][own]
                fixed = lo_fixed[:, 1:ty + 1, 1:tz + 1][own]
                out[n] = np.where(fixed, x[n], ss * done[own]
                                  + mf * mass[ci, y0:y1, z0:z1] * xs)
                written[ci, y0:y1, z0:z1] += 1
            carry, lo, lo_fixed = nxt, hi, hi_fixed
    return out, written


@DTYPES
@pytest.mark.parametrize("case", ["odd_partial_fixes", "x65_dead_row",
                                  "y13_z37", "one_cell_x", "one_cell_z"])
def test_emulated_sweep_matches_plain(case, dtype):
    _, tm = build_pair(case)
    x = vector(tm, seed=32, dtype=dtype)
    ss, mf = scalars(dtype)
    got, written = emulate(tm, x, ss, mf)
    assert (written == 1).all()
    plain = tops.apply_keff_structured_plain(tm, torch.as_tensor(x), ss, mf)
    assert np.isfinite(got).all()
    assert_close(got, plain.numpy(), TOL[dtype])
    bc = tm.bc_mask.numpy()
    np.testing.assert_array_equal(got[bc], x[bc])


# G3_SHAPES cut into 2 slabs and 2 x 2 tiles (the cases padded to divide
# the cut): (npx, npy), 2-D
CUTS = {"slabs_2": ((2, 1), False), "tiles_2x2": ((2, 2), True)}


@DTYPES
@pytest.mark.parametrize("cut", sorted(CUTS))
@pytest.mark.parametrize("case", ["odd_partial_fixes", "x65_dead_row",
                                  "ypad_row", "y13_z37", "one_cell_x"])
def test_emulated_cuts_equal_the_whole_grid(case, cut, dtype):
    """Each shard of the cut, with its x ghosts cut from x and its mask
    ghosts and ghost cells from the global grids (``local_tiles``), swept
    in one launch and in the overlap split's three plane ranges (slabs of
    4 or more planes; the interior launch without X ghosts): every node of
    each range written once, and the gathered cut equal to the whole
    grid's sweep."""
    shape, two_d = CUTS[cut]
    dims, kw = G3_SHAPES[case]
    pads = dict(pad_x_multiple=max(shape[0], kw.get("pad_x_multiple", 1)),
                pad_y_multiple=max(shape[1], kw.get("pad_y_multiple", 1)))
    _, tm = build_pair(case, **pads)
    x = vector(tm, seed=33, dtype=dtype)
    ss, mf = scalars(dtype)
    whole, _ = emulate(tm, x, ss, mf)
    xt_all = torch.as_tensor(x)
    for local in sharding.local_tiles(tm, shape, two_d):
        x0, y0, (xl, yl) = local.x0, local.y0, local.local_extent
        xt = sharding.cut_block(xt_all, x0, y0, xl, yl).numpy()
        ghosts = cut_ghosts(xt_all, x0, y0, xl, yl, two_d)
        want = whole[:, x0:x0 + xl, y0:y0 + yl]
        got, written = emulate(local, xt, ss, mf, ghosts)
        assert (written == 1).all()
        np.testing.assert_array_equal(got, want)
        if xl < 4:
            continue
        split = np.full_like(xt, np.nan)
        for planes, g in (((1, xl - 1), ghosts._replace(x_lo=None, x_hi=None)),
                          ((0, 1), ghosts), ((xl - 1, xl), ghosts)):
            part, written = emulate(local, xt, ss, mf, g, planes)
            p0, p1 = planes
            assert (written[p0:p1] == 1).all() and not written[:p0].any()
            assert not written[p1:].any()
            split[:, p0:p1] = part[:, p0:p1]
        np.testing.assert_array_equal(split, want)
