"""The slender route's kernels K4 (``interior_stencil``) and G2
(``keff_boundary``) as the CUDA kernels lay out their work, checked on the
CPU, where the kernels cannot run:

* K4's sweep geometry (``plane_sweep.stencil_geometry``): the tile and
  chunk it picks from the grid's shape, every node of the grids K4 meets
  (the soil column, 255^3, Z % 4 != 0, n = 1 axes, pad planes) owned by
  one block and plane, shared memory under one H100 block's limit; and a
  numpy emulation of the sweep (zero-filled halo, the outputs each plane
  feeds by the chunk's ends) against the plain K4, for every tile and
  several chunks;
* G2's ghost-tap rows (``keff_boundary.ghost_tap_rows``): each boundary
  class's nonzero taps at the neighbours on the model — 9 for a face or an
  edge, 7 for a corner, the neighbours on one of the node's boundary
  planes — with every other in-grid ghost tap exactly zero, and the z-face
  taps G2 takes by value equal to the sweeps' ``gz``;
* G2's roles (``keff_boundary.boundary_geometry``): the face threads take
  every boundary node once, each by its owning face, pad planes and dead
  rows included, and with the envelope's outputs write every output
  element exactly once;
* a numpy emulation of G2's loop (envelope select and interior class,
  face threads over their class's rows) against the plain G2 at
  1e-5 * max|ref|.

Inputs come from seeded numpy.
"""

import numpy as np
import pytest
import torch

from civiwave_tpu_torch.mesh.structured import build_structured_model
from civiwave_tpu_torch.ops import structured as tops
from civiwave_tpu_torch.ops.cuda import interior_stencil as k4
from civiwave_tpu_torch.ops.cuda import keff_boundary as g2
from civiwave_tpu_torch.ops.cuda import plane_sweep
from civiwave_tpu_torch.physics import materials
from civiwave_tpu_torch.solver.stepper import effective_scalars
from civiwave_tpu_torch.utils.synthetic import cantilever_config

from test_torch_plane_sweep import _owners

torch.set_num_threads(2)

OP_TOL = 1e-5
SS, MF = effective_scalars(2e-3, 0.0909, 3.64e-4)

# node grids K4 meets: the soil column, the 255^3 cantilever, Z % 4 != 0
# (2x3x300 cells), an n = 1 axis (1x3x2), +X pad planes (6x5x4, pad 4)
STENCIL_GRIDS = {
    "soil_column": (1024, 48, 48),
    "cantilever_255": (256, 256, 256),
    "2x3x300": (3, 4, 301),
    "1x3x2": (2, 4, 3),
    "6x5x4_pad_x4": (8, 6, 5),
}

# models G2 meets: cells and build_structured_model options (fixes on
# several faces, +X pad planes, dead +Y rows, n = 1 axes, a column-shaped
# grid, Z % 4 != 0)
BOUNDARY_CASES = {
    "fixes": ((5, 4, 3), dict(fixes=[
        ("x0", (True, True, True), (None, None, None)),
        ("z1", (True, False, True), (1e-3, None, -2e-3)),
        ("y0", (False, True, False), (None, None, None)),
    ])),
    "xpad4": ((6, 5, 4), dict(pad_x_multiple=4, fixed_axis_planes=("x0", "z1"))),
    "ypad4": ((5, 5, 3), dict(pad_y_multiple=4)),
    "nx1": ((1, 3, 2), {}),
    "ny1_nz1": ((3, 1, 1), dict(fixed_axis_planes=("x0", "x1"))),
    "column_39x7x7": ((39, 7, 7), dict(fixed_axis_planes=())),
    "z_longer_than_a_block": ((2, 3, 300), {}),
    "spacing": ((4, 3, 5), dict(spacing=(0.3, 0.7, 1.1))),
}


def _model(case):
    dims, kw = BOUNDARY_CASES[case]
    mat = cantilever_config().materials[0]
    model, _ = build_structured_model(
        *dims, materials.make_properties(mat), mat.density, device="cpu", **kw)
    return model


def _x(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_close(out, ref, rel=OP_TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0.0,
                               atol=rel * (np.abs(ref).max() + 1e-30))


# --- K4: the sweep's geometry and an emulation of the sweep ----------------


@pytest.mark.parametrize("case", sorted(STENCIL_GRIDS))
def test_stencil_geometry_covers_every_node_once(case):
    shape = STENCIL_GRIDS[case]
    geom = plane_sweep.stencil_geometry(shape)
    owners = _owners(shape, geom)
    assert owners.min() == 1 and owners.max() == 1
    ty, tz = geom.tile
    assert geom.threads == ty * tz == 256
    assert geom.planes == (0, shape[0])
    assert geom.smem_bytes == (4 * plane_sweep.STAGES * 3 * (ty + 2)
                               * plane_sweep.STENCIL_TILES[geom.tile])
    assert geom.smem_bytes <= 48 * 1024 <= plane_sweep.SMEM_LIMIT
    assert geom.launch_args() == (ty, tz, geom.chunk, *geom.grid, geom.smem_bytes)
    assert geom.chunk in plane_sweep.STENCIL_CHUNKS


def test_stencil_geometry_follows_the_shape():
    """16 x 16 tiles on the soil column's 48 x 48 planes (8 x 32 would
    idle a quarter of its lanes), 8 x 32 at 255^3; on both the chunk leaves
    eight blocks per SM and every lane of the tile has a node."""
    column = plane_sweep.stencil_geometry((1024, 48, 48))
    full = plane_sweep.stencil_geometry((256, 256, 256))
    assert column.tile == (16, 16) and full.tile == (8, 32)
    assert (column.chunk, column.blocks) == (8, 1152)
    assert (full.chunk, full.blocks) == (32, 2048)
    enough = plane_sweep.STENCIL_BLOCKS_PER_SM * plane_sweep.SM_COUNT
    assert column.blocks >= enough and full.blocks >= enough
    for geom, (Y, Z) in ((column, (48, 48)), (full, (256, 256))):
        gx, gy, _ = geom.grid
        assert gx * geom.tile[1] == Z and gy * geom.tile[0] == Y
    # the 14.4 KB of the 8 x 32 tile, 31.1 KB of the 16 x 16
    assert (full.smem_bytes, column.smem_bytes) == (14400, 31104)
    with pytest.raises(ValueError):
        plane_sweep.stencil_geometry((4, 4, 4), tile=(4, 64))
    with pytest.raises(ValueError):
        plane_sweep.stencil_geometry((0, 4, 4))


def emulate_interior_sweep(xs, taps, geom):
    """numpy emulation of the K4 kernel's sweep: per block the staged
    planes of its tile plus halo (zero outside the grid), each plane added
    to the outputs j - 1, j, j + 1 that lie in the block's chunk, an output
    written when its last plane is in."""
    _, X, Y, Z = xs.shape
    ty, tz = geom.tile
    padded = np.zeros((3, X, Y + ty + 2, Z + tz + 2))
    padded[:, :, 1:Y + 1, 1:Z + 1] = xs
    out = np.full(xs.shape, np.nan)
    gx, gy, gz = geom.grid
    for bz in range(gz):
        x_lo = bz * geom.chunk
        x_hi = min(x_lo + geom.chunk, X)
        for by in range(gy):
            for bx in range(gx):
                y0, z0 = by * ty, bx * tz
                acc = np.zeros((3, 3, ty, tz))
                for j in range(max(x_lo - 1, 0), min(x_hi, X - 1) + 1):
                    plane = padded[:, j, y0:y0 + ty + 2, z0:z0 + tz + 2]
                    for n in range(3):
                        if not x_lo <= j - 1 + n < x_hi:
                            continue
                        for dy in range(3):
                            for dz in range(3):
                                v = plane[:, dy:dy + ty, dz:dz + tz]
                                acc[n] += np.einsum(
                                    "bc,cyz->byz", taps[2 - n, dy, dz], v)
                    if j - 1 >= x_lo:
                        out[:, j - 1, y0:y0 + ty, z0:z0 + tz] = acc[0][
                            :, :min(ty, Y - y0), :min(tz, Z - z0)]
                    acc = np.concatenate([acc[1:], np.zeros((1, 3, ty, tz))])
                if x_hi == X:
                    out[:, X - 1, y0:y0 + ty, z0:z0 + tz] = acc[0][
                        :, :min(ty, Y - y0), :min(tz, Z - z0)]
    return out


@pytest.mark.parametrize("tile", sorted(plane_sweep.STENCIL_TILES))
@pytest.mark.parametrize("shape, chunk", [
    ((8, 6, 5), 3), ((2, 4, 3), 1), ((7, 19, 20), 2), ((5, 3, 37), 8),
])
def test_sweep_emulation_matches_plain(tile, shape, chunk):
    mat = cantilever_config().materials[0]
    model, _ = build_structured_model(
        4, 3, 5, materials.make_properties(mat), mat.density, device="cpu")
    taps = tops.interior_taps(model)
    xs = _x((3,) + shape, seed=3)
    geom = plane_sweep.stencil_geometry(shape, tile=tile, chunk=chunk)
    ref = k4.interior_stencil_plain(torch.from_numpy(xs), taps).numpy()
    out = emulate_interior_sweep(xs.astype(np.float64),
                                 taps.astype(np.float32).astype(np.float64), geom)
    assert not np.isnan(out).any()  # every output written
    _assert_close(out, ref)


# --- G2: the ghost-tap rows ------------------------------------------------


@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (0.3, 0.7, 1.1)])
def test_ghost_tap_rows_are_the_boundary_plane_neighbours(spacing):
    mat = cantilever_config().materials[0]
    model, _ = build_structured_model(
        2, 2, 2, materials.make_properties(mat), mat.density, spacing=spacing,
        device="cpu")
    spacing, lam0, mu0 = model.spacing, model.lam0, model.mu0
    codes, rows = g2.ghost_tap_rows(spacing, lam0, mu0)
    ghost = tops.ghost_stencil_table(spacing, lam0, mu0)
    counts = {0: 0, 1: 9, 2: 9, 3: 7}  # boundary axes -> nonzero taps
    for cls, classes in enumerate(np.ndindex(3, 3, 3)):
        boundary = [a for a in range(3) if classes[a] != 1]
        assert codes[cls, 0] == counts[len(boundary)], classes
        want = []
        for d in np.ndindex(3, 3, 3):
            off = [d[a] - 1 for a in range(3)]
            inward = {0: 1, 2: -1}
            if any(classes[a] != 1 and off[a] not in (0, inward[classes[a]])
                   for a in range(3)):
                continue  # off the model
            code = (d[0] * 3 + d[1]) * 3 + d[2]
            # on one of the node's boundary planes, or coupled only
            # through cells that exist: then its ghost tap is exactly zero
            if any(off[a] == 0 for a in boundary):
                want.append(code)
            else:
                assert not ghost[cls, code].any(), (classes, off)
        k = codes[cls, 0]
        assert list(codes[cls, 1:1 + k]) == want
        for i, code in enumerate(want):
            np.testing.assert_array_equal(rows[cls, i], ghost[cls, code].reshape(9))
            assert ghost[cls, code].any()
        assert not rows[cls, k:].any() and not codes[cls, 1 + k:].any()
    # the z faces' rows, by value in the kernel, are the sweeps' gz taps
    ztaps = g2.z_face_taps(spacing, lam0, mu0)
    sweep = tops.sweep_taps(spacing, lam0, mu0)
    np.testing.assert_array_equal(ztaps, sweep[plane_sweep.FACTORED_TAPS:])


# --- G2: the block roles and an emulation of the loop ----------------------


@pytest.mark.parametrize("case", sorted(BOUNDARY_CASES))
def test_boundary_roles_write_every_output_once(case):
    model = _model(case)
    X, Y, Z = model.grid_shape
    cells = (model.nx, model.ny, model.nz)
    bc = model.bc_mask.numpy()
    for vec in (0, 1):
        geom = g2.boundary_geometry(model.grid_shape, cells, vec)
        ix, iy, iz = geom.face_coords()
        assert geom.xy_blocks * g2.BOUNDARY_THREADS >= geom.xy_nodes
        assert geom.blocks == geom.xy_blocks + geom.slabs * (
            geom.slab_envelope + geom.slab_z)
        # the envelope threads take every node once
        assert (geom.envelope_nodes() == 1).all()
        taken = np.zeros((X, Y, Z), dtype=np.int64)
        np.add.at(taken, (ix, iy, iz), 1)
        classes = g2.node_classes(model.grid_shape, cells)
        # every boundary node (pad planes and dead rows too) once, no other
        np.testing.assert_array_equal(taken, (classes != g2.INTERIOR_CLASS))
        # each by its owning face: x faces own their planes, y faces their
        # rows with x interior, z faces the rest
        cx, cy = classes[ix, iy, iz] // 9, classes[ix, iy, iz] // 3 % 3
        a = geom.x_planes * Y * Z
        b = geom.xy_nodes - a
        seg = np.repeat([0, 1, 2], [a, b, len(ix) - a - b])
        assert (cx[seg == 0] != 1).all()
        assert (cx[seg > 0] == 1).all() and (cy[seg == 1] != 1).all()
        assert (cy[seg == 2] == 1).all()
        assert np.isin(classes[ix[seg == 2], iy[seg == 2], iz[seg == 2]],
                       g2.Z_FACE_CLASSES).all()
        # x- and y-face threads along z; a z-face tile's threads along y
        assert (np.diff(iz[:a + b])[np.diff(iy[:a + b]) == 0] == 1).all()
        same = (np.diff(ix[a + b:]) == 0) & (np.diff(iz[a + b:]) == 0)
        assert (np.diff(iy[a + b:])[same] == 1).all()
        # a z-face tile lies in its slab's x range
        slab = np.repeat(np.arange(geom.slabs), geom.slab_z)
        assert len(slab) == geom.slabs * geom.slab_z
        assert (ix[seg == 2] // g2.SLAB < geom.slabs).all()
        # outputs: the envelope's plus the face threads' free components
        writes = geom.envelope_owned(bc).astype(np.int64)
        face = np.zeros((3, X, Y, Z), dtype=bool)
        face[:, ix, iy, iz] = True
        writes += face & ~bc
        assert (writes == 1).all()
    if case in ("xpad4", "ypad4"):
        pad = np.zeros((X, Y, Z), dtype=bool)
        pad[model.nx + 1:] = True
        pad[:, model.ny + 1:] = True
        assert pad.any() and bc[:, pad].all()


def emulate_keff_boundary_loop(model, interior, x, ss, mf):
    """numpy emulation of the G2 kernel: the envelope's outputs (interior
    class and constrained components), then each face thread's node: its
    class's ghost-tap rows on the sanitized neighbours, the free outputs."""
    X, Y, Z = model.grid_shape
    cells = (model.nx, model.ny, model.nz)
    geom = g2.boundary_geometry(model.grid_shape, cells, 0)
    codes, rows = g2.ghost_tap_rows(model.spacing, model.lam0, model.mu0)
    bc = model.bc_mask.numpy()
    xs = np.where(bc, 0.0, x)
    classes = g2.node_classes(model.grid_shape, cells)
    m8 = float(np.float32(model.m8))
    out = np.full(x.shape, np.nan)
    envelope = geom.envelope_owned(bc)
    out[envelope] = np.where(bc, x, ss * interior + mf * m8 * x)[envelope]
    for ix, iy, iz in zip(*geom.face_coords()):
        cls = classes[ix, iy, iz]
        corr = np.zeros(3)
        for k in range(codes[cls, 0]):
            d = codes[cls, 1 + k]
            dx, dy, dz = d // 9 - 1, d // 3 % 3 - 1, d % 3 - 1
            v = xs[:, ix + dx, iy + dy, iz + dz]
            corr += rows[cls, k].reshape(3, 3).astype(np.float64) @ v
        weight = np.prod([1.0 if c == 1 else 0.5
                          for c in (cls // 9, cls // 3 % 3, cls % 3)])
        for b in range(3):
            if not bc[b, ix, iy, iz]:
                out[b, ix, iy, iz] = (ss * (interior[b, ix, iy, iz] - corr[b])
                                      + mf * m8 * weight * x[b, ix, iy, iz])
    return out


@pytest.mark.parametrize("case", sorted(BOUNDARY_CASES))
def test_boundary_loop_emulation_matches_plain(case):
    model = _model(case)
    x = _x(model.vector_shape, seed=5)
    xs = torch.from_numpy(x).masked_fill(model.bc_mask, 0.0)
    interior = k4.interior_stencil_plain(xs, tops.interior_taps(model))
    ref = g2.keff_boundary_plain(model, interior, torch.from_numpy(x), SS, MF)
    out = emulate_keff_boundary_loop(
        model, interior.numpy().astype(np.float64), x.astype(np.float64),
        float(SS), float(MF))
    assert not np.isnan(out).any()
    _assert_close(out, ref.numpy())
    bc = model.bc_mask.numpy()
    np.testing.assert_array_equal(out[bc], x[bc])


def test_boundary_geometry_refuses_other_grids():
    with pytest.raises(ValueError):  # a Z pad: the high z face would move
        g2.boundary_geometry((4, 4, 6), (3, 3, 4), 0)
    with pytest.raises(ValueError):  # no room for the high x face
        g2.boundary_geometry((3, 4, 4), (3, 3, 3), 0)
    geom = g2.boundary_geometry((1024, 48, 48), (1023, 47, 47), 1)
    # the soil column: 2 x-face planes, 2 y-face rows per interior plane,
    # then 64 slabs of 16 planes, each 36 envelope blocks (16 x 48 x 48
    # nodes, 4 per thread) and 2 x 3 z-face tiles
    assert geom.xy_nodes == 2 * 48 * 48 + 1022 * 2 * 48
    assert (geom.slabs, geom.slab_envelope, geom.slab_z) == (64, 36, 6)
    ix, _, _ = geom.face_coords()
    assert len(ix) == 196_744  # boundary nodes of 2,359,296
