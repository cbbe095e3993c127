"""The port's shard-local operator (plain K5) against the JAX sharded one.

In one process, with no process group: each shard's block is cut from a
global vector made with seeded numpy, its ghost planes and rows are cut
from its neighbours' edges (zero past the global ends, as ``ppermute``
fills them), and ``ops.structured_sharded.local_keff`` (the plain K5, one
call or the overlap split's three) runs on it.  The gathered result is held
at 1e-5 * max|ref| against the reference's ``apply_keff_structured_sharded``
on the conftest's 8 virtual CPU devices, both through the Pallas K5 in
interpret mode and through its XLA local form (the GSPMD fallback in 2-D),
and against the reference's unsharded operator, on the reference's own 1-D
and 2-D grids (tests/test_sharding.py:183-185, :585-586), with
``CIVIWAVE_HALO_OVERLAP`` 0 and 1.

Also here: K3's plain version with global offsets, the dead +Y rows
through the builder, ``to_nodal``/``from_nodal`` and ``convert``, the
shard preconditioner's class table, a one-rank gloo group through the
normal dispatch and through ``shard_simulation`` (a scenario with a time
curve and adaptive dt), and the ``ShardError`` checks.
"""

import dataclasses
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from civiwave_tpu.mesh import structured as jstructured
from civiwave_tpu.parallel import sharding as jsharding
from civiwave_tpu.physics import materials as jmaterials
from civiwave_tpu_torch import convert
from civiwave_tpu_torch.mesh import structured as tstructured
from civiwave_tpu_torch.ops import structured as tops
from civiwave_tpu_torch.ops import structured_sharded as tss
from civiwave_tpu_torch.parallel import sharding as tsharding
from civiwave_tpu_torch.physics import materials as tmaterials
from civiwave_tpu_torch.utils.errors import ShardError
from civiwave_tpu_torch.utils.synthetic import cantilever_config

torch.set_num_threads(2)

CPU = torch.device("cpu")
OP_TOL = 1e-5
SS, MF = np.float32(1.01), np.float32(3.7)

# name -> (cells, (npx, npy), 2-D)
GRIDS = {
    "1d_6x3x3_over_8": ((6, 3, 3), (8, 1), False),  # Xl = 1
    "1d_9x4x5_over_4": ((9, 4, 5), (4, 1), False),
    "1d_15x4x4_over_4": ((15, 4, 4), (4, 1), False),  # Xl = 4: the split
    "2d_9x4x5_on_2x4": ((9, 4, 5), (2, 4), True),  # 3 dead +Y rows
    "2d_7x7x3_on_2x2": ((7, 7, 3), (2, 2), True),
    "2d_6x5x4_on_4x2": ((6, 5, 4), (4, 2), True),
}


def _material():
    return cantilever_config().materials[0]


@lru_cache(maxsize=None)
def _pair(cells, shape, two_d):
    """(JAX model, JAX force, port model) of the padded cantilever."""
    mat = _material()
    kw = dict(traction=(0.0, 0.0, -1.0e6), pad_x_multiple=shape[0],
              pad_y_multiple=shape[1] if two_d else 1)
    jm, jf = jstructured.build_structured_model(
        *cells, jmaterials.make_properties(mat), mat.density, **kw
    )
    tm, _ = tstructured.build_structured_model(
        *cells, tmaterials.make_properties(mat), mat.density, device=CPU, **kw
    )
    return jm, jf, tm


def _x(model, seed=7):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(model.vector_shape).astype(np.float32)


@lru_cache(maxsize=None)
def _jax_outputs(name):
    """The reference's sharded operator (Pallas K5 in interpret mode, and
    its XLA local form) and its unsharded operator on the grid's x."""
    cells, (npx, npy), two_d = GRIDS[name]
    jm, jf, _ = _pair(cells, (npx, npy), two_d)
    x = jnp.asarray(_x(jm))
    apply = jax.jit(lambda m, v: m.apply_keff(v, SS, MF))
    outs = {"unsharded": np.asarray(apply(jm, x))}
    if two_d:
        mesh = jsharding.make_device_mesh_2d(npx, npy)
        sm, _, _ = jsharding.shard_structured(
            jm, jm.zero_state(), jf, mesh, axis_name_y="shard_y"
        )
        spec = jax.sharding.PartitionSpec(None, "shard", "shard_y")
    else:
        mesh = jsharding.make_device_mesh(npx)
        sm, _, _ = jsharding.shard_structured(jm, jm.zero_state(), jf, mesh)
        spec = jax.sharding.PartitionSpec(None, "shard")
    xs = jax.device_put(x, jax.sharding.NamedSharding(mesh, spec))
    outs["xla"] = np.asarray(apply(sm, xs))
    outs["pallas"] = np.asarray(
        apply(dataclasses.replace(sm, pallas_interpret=True), xs)
    )
    return outs


def port_sharded(model, x, shape, two_d):
    """The gathered port operator over every tile of ``shape``, each tile
    given the ghosts cut from ``x`` (no group)."""
    out = torch.empty_like(x)
    for local in tsharding.local_tiles(model, shape, two_d):
        x0, y0, (xl, yl) = local.x0, local.y0, local.local_extent
        xt = tsharding.cut_block(x, x0, y0, xl, yl)
        ghosts = tss.cut_ghosts(x, x0, y0, xl, yl, two_d)
        out[:, x0:x0 + xl, y0:y0 + yl] = tss.local_keff(local, xt, ghosts, SS, MF)
    return out


def _assert_close(out, ref, rel=OP_TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0.0,
                               atol=rel * (np.abs(ref).max() + 1e-30))


@pytest.mark.parametrize("overlap", ["0", "1"])
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_shard_operator_matches_reference(name, overlap, monkeypatch):
    monkeypatch.setenv("CIVIWAVE_HALO_OVERLAP", overlap)
    cells, shape, two_d = GRIDS[name]
    _, _, tm = _pair(cells, shape, two_d)
    out = port_sharded(tm, torch.as_tensor(_x(tm)), shape, two_d).numpy()
    refs = _jax_outputs(name)
    for key in ("pallas", "xla", "unsharded"):
        _assert_close(out, refs[key])


def test_overlap_split_matches_one_call(monkeypatch):
    """The three plane-range calls write the same values as one call."""
    cells, shape, two_d = GRIDS["1d_15x4x4_over_4"]
    _, _, tm = _pair(cells, shape, two_d)
    x = torch.as_tensor(_x(tm, seed=13))
    outs = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("CIVIWAVE_HALO_OVERLAP", flag)
        outs[flag] = port_sharded(tm, x, shape, two_d)
    _assert_close(outs["1"], outs["0"], 1e-6)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_block_jacobi_offsets_match_unsharded(name):
    """K3's plain version on each tile, classifying by global coordinate,
    equals the unsharded apply; the shard's table (from the class proxy)
    equals the unsharded model's bit for bit."""
    cells, shape, two_d = GRIDS[name]
    _, _, tm = _pair(cells, shape, two_d)
    pc = tm.build_preconditioner(SS, MF)
    r = torch.as_tensor(_x(tm, seed=5))
    ref = tm.apply_preconditioner(pc, r)
    out = torch.empty_like(r)
    for local in tsharding.local_tiles(tm, shape, two_d):
        x0, y0, (xl, yl) = local.x0, local.y0, local.local_extent
        sharded = dataclasses.replace(local, shard_group=object())
        table = tops.build_compact_block_jacobi(sharded, SS, MF).table
        assert torch.equal(table, pc.table)
        rt = tsharding.cut_block(r, x0, y0, xl, yl)
        out[:, x0:x0 + xl, y0:y0 + yl] = local.apply_preconditioner(pc, rt)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("cells,npy", [((9, 4, 5), 4), ((4, 6, 3), 3)])
def test_pad_rows_builder_and_nodal_round_trip(cells, npy):
    """Dead +Y rows: the builder's fields equal the reference's bit for
    bit; to_nodal strips the rows and from_nodal puts them back (zeros),
    as the reference's; convert carries pad_rows."""
    jm, jf, tm = _pair(cells, (2, npy), True)
    assert tm.pad_rows == jm.pad_rows > 0
    for name in convert.STRUCTURED_ARRAYS:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)), name)
    x = _x(tm, seed=11)
    rows = tm.to_nodal(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(rows, np.asarray(jm.to_nodal(jnp.asarray(x))))
    assert rows.shape == (tm.node_count, 3)
    back = tm.from_nodal(rows).numpy()
    np.testing.assert_array_equal(back, np.asarray(jm.from_nodal(rows)))
    assert not back[:, :, tm.ny + 1:].any()
    arrays = {name: np.asarray(getattr(jm, name))
              for name in convert.STRUCTURED_ARRAYS}
    meta = {name: getattr(jm, name) for name in convert.STRUCTURED_META}
    carried = convert.structured_model_from_arrays(arrays, meta, CPU)
    assert carried.pad_rows == jm.pad_rows
    assert carried.vector_shape == tm.vector_shape


def test_one_rank_group_runs_the_sharded_dispatch(monkeypatch):
    """A one-rank gloo group (HashStore, no network): shard_structured,
    then apply_keff through the normal dispatch (2 or 4 counted exchanges
    per matvec) equals the unsharded operator; gathered, its nodal rows
    equal the unsharded ones."""
    from civiwave_tpu_torch.parallel import collectives

    cells, shape, two_d = (9, 4, 5), (1, 1), False
    _, _, tm = _pair(cells, shape, two_d)
    x = torch.as_tensor(_x(tm))
    ref = tm.apply_keff(x, SS, MF)
    try:
        for make, exchanges in (
            (lambda: tsharding.make_shard_group(1, "cpu"), 2),
            (lambda: tsharding.make_shard_group_2d(1, 1, "cpu"), 4),
        ):
            group = make()
            sm, ss_, sf = tsharding.shard_structured(
                tm, tm.zero_state(), torch.zeros_like(x), group
            )
            collectives.reset_counts()
            out = sm.apply_keff(x, SS, MF)
            assert collectives.ppermute.calls == exchanges
            _assert_close(out, ref)
            gathered = tsharding.gather_structured(out, group)
            assert torch.equal(sm.to_nodal(gathered), tm.to_nodal(out))
    finally:
        tsharding.close_shard_group()


def test_shard_errors():
    """The reference's divisibility checks, the GPU count, an
    uninitialised several-rank group; absorbing faces now shard (their
    face terms on every cut equal the global term's)."""
    _, _, tm = _pair((6, 3, 3), (1, 1), False)  # X = 7, Y = 4
    with pytest.raises(ShardError, match="X extent"):
        tsharding.shard_layout(tm, (2, 1), (0, 0))
    with pytest.raises(ShardError, match="Y extent"):
        tsharding.shard_layout(tm, (1, 3), (0, 0))
    with pytest.raises(ShardError, match="GPUs"):
        tsharding.make_shard_group(torch.cuda.device_count() + 1, "cuda")
    with pytest.raises(ShardError, match="not initialised"):
        tsharding.make_shard_group(2, "cpu")
    mat = _material()
    absorbing, _ = tstructured.build_structured_model(
        4, 3, 3, tmaterials.make_properties(mat), mat.density,
        absorb_planes=("z0",), pad_x_multiple=2, device=CPU,
    )
    _assert_face_terms_of_the_cut(absorbing, (2, 1), False)


def _assert_face_terms_of_the_cut(model, shape, two_d):
    """Every tile's absorbing-face term (C x of the faces it holds, at
    global coordinates) is the global term's block, bit for bit."""
    x = torch.from_numpy(_x(model))
    ref = tops.absorbing_force_structured(model, x)
    for tile in tsharding.local_tiles(model, shape, two_d):
        block = tsharding.cut_block(x, tile.x0, tile.y0, *tile.local_extent)
        want = tsharding.cut_block(ref, tile.x0, tile.y0, *tile.local_extent)
        assert torch.equal(tops.absorbing_force_structured(tile, block), want)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_absorbing_face_terms_of_every_cut_equal_the_global_term(name):
    """Faces ("x1", "y0", "y1", "z0") on the reference's cuts, the X-padded
    and dead-row grids among them: only the end slabs and edge tiles hold
    x/y faces, the padded grid's x1 plane lies inside a slab, and the
    halved tributary areas fall on the global edges."""
    cells, shape, two_d = GRIDS[name]
    mat = _material()
    model, _ = tstructured.build_structured_model(
        *cells, tmaterials.make_properties(mat), mat.density,
        pad_x_multiple=shape[0], pad_y_multiple=shape[1] if two_d else 1,
        absorb_planes=("x1", "y0", "y1", "z0"), device=CPU,
    )
    _assert_face_terms_of_the_cut(model, shape, two_d)


def test_shard_simulation_steps_a_curve_scenario_on_one_rank():
    """examples/cantilever_box.yaml (a ramped traction, adaptive dt)
    through build_simulation and shard_simulation over a one-rank gloo
    group: the sharded run ('auto' = fused on a shard) takes the frames,
    dt and nodal fields of the unsharded fused run."""
    from civiwave_tpu_torch.runner import build_simulation

    scenario = str(Path(__file__).resolve().parents[1] / "examples"
                   / "cantilever_box.yaml")
    ref = build_simulation(scenario, device=CPU)
    ref.stepper.solver_variant = "fused"
    tel_ref = ref.run(5)
    try:
        sim = tsharding.shard_simulation(
            build_simulation(scenario, device=CPU),
            tsharding.make_shard_group(1, "cpu"),
        )
        assert sim.model.shard_group is not None
        assert sim.force_schedule.curve_parts
        tel = sim.run(5)
        u, a = sim.stepper.displacement(), sim.stepper.acceleration()
    finally:
        tsharding.close_shard_group()
    assert [t.pcg_iterations for t in tel] == [t.pcg_iterations for t in tel_ref]
    assert [t.time_step for t in tel] == [t.time_step for t in tel_ref]
    u_ref, a_ref = ref.stepper.displacement(), ref.stepper.acceleration()
    np.testing.assert_allclose(u, u_ref, rtol=0, atol=2.5e-4 * np.abs(u_ref).max())
    np.testing.assert_allclose(a, a_ref, rtol=0, atol=3e-3 * np.abs(a_ref).max())


def test_shard_simulation_of_the_general_path_matches_unsharded():
    """A simulation without a structured force schedule (the general
    gather path) shards.  Over a one-rank gloo group it keeps the
    single-device operator with the group's reductions ('auto' stays
    classic, as the reference's unmarked model), so its frames equal the
    unsharded run's; a 2-D group is refused."""
    from civiwave_tpu_torch.runner import build_simulation

    cfg = cantilever_config(mesh={"path": "synthetic://box/8,3,3,tet"},
                            tol_runtime=2e-4, max_iters=120, dt=1e-3,
                            adaptive=False)
    ref = build_simulation(cfg, device=CPU)
    tel_ref = ref.run(3)
    try:
        group = tsharding.make_shard_group(1, "cpu")
        sim = tsharding.shard_simulation(build_simulation(cfg, device=CPU),
                                         group)
        assert sim.model.shard_group is group and not sim.model.halo
        assert sim.model.vector_shape == ref.model.vector_shape
        tel = sim.run(3)
        u = sim.stepper.displacement()
        with pytest.raises(ShardError, match="1-D"):
            tsharding.shard_general(
                ref.model, ref.stepper.state, ref.stepper.external_force,
                dataclasses.replace(group, two_d=True))
    finally:
        tsharding.close_shard_group()
    assert [t.pcg_iterations for t in tel] == [t.pcg_iterations for t in tel_ref]
    np.testing.assert_array_equal(u, ref.stepper.displacement())
