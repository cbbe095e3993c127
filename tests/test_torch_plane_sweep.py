"""The launch geometry of the plane-sweep kernels K1/K5, K2 and K6
(``ops/cuda/plane_sweep.py``), checked on the CPU: over the grids the
kernels meet, and over the plane ranges K5 sweeps (the overlap split's
three, one-plane slabs, 2-D tiles), every node of the range belongs to
exactly one block and plane and none outside it, the shared memory fits
one H100 block, and the 255^3 cantilever fills the card.  Also the
interior taps the kernels take by value."""

import numpy as np
import pytest
import torch

from civiwave_tpu_torch.convert import structured_model_from_arrays
from civiwave_tpu_torch.mesh.structured import build_structured_model
from civiwave_tpu_torch.ops.cuda import plane_sweep
from civiwave_tpu_torch.ops.cuda.structured_stencil import sweep_taps32
from civiwave_tpu_torch.parallel import sharding
from civiwave_tpu_torch.ops.structured import (
    apply_keff_structured_plain,
    class_stencil_table,
    expand_factored,
)
from civiwave_tpu_torch.physics import materials
from civiwave_tpu_torch.utils.synthetic import cantilever_config

# cells and X padding multiple: the five grids of the CUDA tests' SHAPES,
# the 255^3 cantilever, and a grid ragged against the tile along Y and Z
# and against the chunk along X
GRIDS = {
    "fixes_x0_z1": ((5, 4, 3), 1),
    "nx1": ((1, 3, 2), 1),
    "xpad4": ((6, 5, 4), 4),
    "odd_partial_fixes": ((17, 9, 33), 1),
    "z_longer_than_a_block": ((2, 3, 300), 1),
    "cantilever_255": ((255, 255, 255), 1),
    "ragged_33x19x45": ((33, 19, 45), 1),
}
SM_COUNT = 132  # H100 SXM


def _nodes(cells, pad_x):
    nx, ny, nz = cells
    return (-(-(nx + 1) // pad_x) * pad_x, ny + 1, nz + 1)


def _owners(shape, geom):
    """How many blocks of ``geom`` write each node of ``shape``."""
    owners = np.zeros(shape, dtype=np.uint8)
    gx, gy, gz = geom.grid
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                (x0, x1), (y0, y1), (z0, z1) = geom.owned((bx, by, bz), shape)
                assert x0 < x1 and y0 < y1 and z0 < z1  # no empty block
                assert x1 - x0 <= geom.chunk
                assert y1 - y0 <= geom.tile[0] and z1 - z0 <= geom.tile[1]
                owners[x0:x1, y0:y1, z0:z1] += 1
    return owners


@pytest.mark.parametrize("case", sorted(GRIDS))
def test_sweep_geometry_covers_every_node_once(case):
    cells, pad_x = GRIDS[case]
    shape = _nodes(cells, pad_x)
    assert shape[0] % pad_x == 0
    for vectors in (1, 3):
        geom = plane_sweep.sweep_geometry(shape, vectors)
        owners = _owners(shape, geom)
        assert owners.min() == 1 and owners.max() == 1
        assert geom.threads == geom.tile[0] * geom.tile[1] <= 1024
        assert geom.threads % 32 == 0
        assert geom.smem_bytes <= plane_sweep.SMEM_LIMIT
        assert geom.partials_shape == (3, geom.blocks)
        assert geom.launch_args() == (*geom.tile, geom.chunk, *geom.grid,
                                      geom.smem_bytes)
        if case == "cantilever_255":
            assert geom.blocks > 2 * SM_COUNT


def _check_ranges(shape, ranges):
    """Each range's blocks write its planes once and nothing else; the
    ranges together write every plane once."""
    total = np.zeros(shape, dtype=np.uint8)
    for p0, p1 in ranges:
        geom = plane_sweep.sweep_geometry(shape, 1, (p0, p1))
        assert geom.planes == (p0, p1)
        assert geom.grid[2] == -(-(p1 - p0) // plane_sweep.CHUNK_X)
        owners = _owners(shape, geom)
        assert (owners[p0:p1] == 1).all()
        assert not owners[:p0].any() and not owners[p1:].any()
        total += owners
    assert (total == 1).all()


def _split_ranges(xl):
    """The overlap split's three launches (ops/structured_sharded.py)."""
    return [(1, xl - 1), (0, 1), (xl - 1, xl)]


@pytest.mark.parametrize("case", sorted(GRIDS))
def test_sweep_geometry_split_ranges_on_every_grid(case):
    cells, pad_x = GRIDS[case]
    shape = _nodes(cells, pad_x)
    if shape[0] < 4:  # the split needs four planes; one range each
        _check_ranges(shape, [(p, p + 1) for p in range(shape[0])])
    else:
        _check_ranges(shape, _split_ranges(shape[0]))


@pytest.mark.parametrize("xl", [4, 64, 65, 256])
def test_sweep_geometry_split_ranges_on_slabs(xl):
    """Slabs of the 255^3 cut over 4 (Xl = 64) and the whole slab, and the
    smallest slab the split takes; the interior launch spans chunks."""
    shape = (xl, 12, 40)
    _check_ranges(shape, _split_ranges(xl))
    interior = plane_sweep.sweep_geometry(shape, 1, (1, xl - 1))
    assert interior.grid[2] == -(-(xl - 2) // plane_sweep.CHUNK_X)


def test_sweep_geometry_one_plane_slabs():
    """The 6x3x3 grid over 8 slabs: each shard a single plane, swept alone
    with its halo planes from both ghosts."""
    mat = cantilever_config().materials[0]
    model, _ = build_structured_model(
        6, 3, 3, materials.make_properties(mat), mat.density,
        pad_x_multiple=8, device="cpu")
    tiles = sharding.local_tiles(model, (8, 1), False)
    assert [t.grid_shape[0] for t in tiles] == [1] * 8
    for tile in tiles:
        _check_ranges(tile.grid_shape, [(0, 1)])


def test_sweep_geometry_2d_tiles_with_dead_rows():
    """The 9x4x5 grid on 2x4 tiles (chip_smoke phase 14): 5 node rows
    padded to 8, so the top tiles hold only dead +Y rows; each tile's
    geometry covers its own (Xl, Yl, Z) block, whole and split."""
    mat = cantilever_config().materials[0]
    model, _ = build_structured_model(
        9, 4, 5, materials.make_properties(mat), mat.density,
        pad_x_multiple=2, pad_y_multiple=4, device="cpu")
    tiles = sharding.local_tiles(model, (2, 4), True)
    assert len(tiles) == 8 and model.pad_rows == 3
    for tile in tiles:
        xl, yl, z = tile.grid_shape
        assert (xl, yl, z) == (5, 2, 6)
        _check_ranges(tile.grid_shape, [(0, xl)])
        _check_ranges(tile.grid_shape, _split_ranges(xl))


def test_sweep_geometry_refuses_bad_ranges():
    shape = (8, 4, 4)
    for planes in ((-1, 3), (2, 9), (5, 4)):
        with pytest.raises(ValueError):
            plane_sweep.sweep_geometry(shape, 1, planes)
    empty = plane_sweep.sweep_geometry(shape, 1, (3, 3))
    assert empty.grid[2] == 0 and empty.blocks == 0
    assert plane_sweep.sweep_geometry(shape, 1).planes == (0, 8)


def test_sweep_geometry_shared_memory():
    """K1/K5 stage x and K2 r (1 vector), K6 r, w and s (3): a ring of staging
    buffers, each 10 rows x 40 floats per channel and 10 x 40 mask bytes
    per component, plus one transformed 10 x 34 plane of 3 components."""
    k2 = plane_sweep.sweep_geometry((256, 256, 256), 1)
    k6 = plane_sweep.sweep_geometry((256, 256, 256), 3)
    n = plane_sweep.STAGES
    assert k2.smem_bytes == 4 * (n * 3 * 400 + 3 * 340) + n * 3 * 400
    assert k6.smem_bytes == 4 * (n * 9 * 400 + 3 * 340) + n * 3 * 400
    assert (k2.smem_bytes, k6.smem_bytes) == (22080, 50880)
    with pytest.raises(ValueError):
        plane_sweep.sweep_geometry((0, 4, 4), 1)


def test_models_carry_the_sweep_taps():
    """The host copy K1/K5, K2 and K6 pass by value: the class table's
    interior row in factored form (every tap not zero in structure equal
    to the f32 table's, the others at most 1e-12 of the largest), then the
    z-face ghost taps at dz = 0, on models from the builder and from
    arrays."""
    mat = cantilever_config().materials[0]
    model, _ = build_structured_model(
        4, 3, 5, materials.make_properties(mat), mat.density, device="cpu"
    )
    table = class_stencil_table(model.spacing, model.lam0, model.mu0)
    taps = sweep_taps32(model)
    assert taps.shape == (plane_sweep.SWEEP_TAPS,)
    assert taps.dtype == np.float32
    interior = expand_factored(taps[:plane_sweep.FACTORED_TAPS]).reshape(-1)
    structural = interior != 0
    assert structural.sum() == 153
    for row in (table[13].reshape(-1),
                model.stencil_table[13].numpy().reshape(-1)):
        np.testing.assert_array_equal(interior[structural], row[structural])
        assert np.abs(row[~structural]).max() <= 1e-12 * np.abs(row).max()
    arrays = {name: getattr(model, name).numpy() for name in (
        "lam_grid", "mu_grid", "mass_grid", "bc_mask", "bc_value", "position0")}
    meta = {name: getattr(model, name) for name in (
        "nx", "ny", "nz", "node_count", "padded_node_count", "pad_planes",
        "pad_rows", "spacing", "lam0", "mu0", "absorb_faces", "rho_cp",
        "rho_cs")}
    again = structured_model_from_arrays(arrays, meta, "cpu")
    np.testing.assert_array_equal(again.sweep_taps, model.sweep_taps)


@pytest.mark.parametrize("side, z", [(0, 0), (1, -1)], ids=["z0", "z1"])
def test_sweep_taps_give_the_z_face_stencil(side, z):
    """What K1/K5, K2 and K6 do at a z-face column of an interior row: the
    factored interior taps over all 27 neighbours, minus the face class's
    ghost taps
    at the dz = 0 neighbours, equal the plain operator there (the
    neighbours across the face are outside the grid)."""
    mat = cantilever_config().materials[0]
    model, _ = build_structured_model(
        4, 4, 4, materials.make_properties(mat), mat.density,
        fixed_axis_planes=(), device="cpu",
    )
    rng = np.random.default_rng(5)
    u = rng.standard_normal(model.vector_shape).astype(np.float64)
    ref = apply_keff_structured_plain(model, torch.as_tensor(u), 1.0, 0.0).numpy()
    taps = model.sweep_taps.astype(np.float64)
    interior = expand_factored(taps[:plane_sweep.FACTORED_TAPS])
    ghost = taps[plane_sweep.FACTORED_TAPS:].reshape(2, 3, 3, 3, 3)[side]
    X, Y, Z = model.grid_shape
    iz = z % Z
    for ix, iy in ((2, 2), (1, 3)):
        out = np.zeros(3)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    if not 0 <= iz + dz < Z:
                        continue
                    v = u[:, ix + dx, iy + dy, iz + dz]
                    out += interior[dx + 1, dy + 1, dz + 1] @ v
                    if dz == 0:
                        out -= ghost[dx + 1, dy + 1] @ v
        np.testing.assert_allclose(out, ref[:, ix, iy, iz], rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max())
