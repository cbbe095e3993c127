"""The port's banded halo plan and its in-process shard operator against
the JAX reference (no group):

* ``parallel.general_halo.plan_general_halo`` equals the reference's
  planner table for table on the reference's ``_general_fixture`` boxes
  (tests/test_sharding.py:953-969: (24,3,3) hex and (20,4,3) tet, packed
  with pads of 64) at 4 and 8 shards, both given the same model (the JAX
  one carried across by ``convert``); both are None on the reference's
  4x2x2 bar at 8 shards (G > L) and on a mixed tet + hex mesh;
* the in-process 4-shard operator (``local_general_shards`` and
  ``chip_smoke.local_keff_general``, the plain K7 and G1) against the
  reference's unsharded ``apply_keff`` at 1e-5 * max|ref|
  (test_sharding.py:996-998) for tet, hex and a tet box with dashpots, and
  bit-equal to the port's unsharded operator off the ghost bands;
* ``convert`` carries the reference's plan, and the port's shards built
  from it give its own plan's output bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from civiwave_tpu.mesh import pack as jpack
from civiwave_tpu.mesh import preprocess as jpreprocess
from civiwave_tpu.parallel.general_halo import plan_general_halo as jplan
from civiwave_tpu.physics import materials as jmaterials
from civiwave_tpu.utils import synthetic as jsynthetic
from civiwave_tpu_torch.ops import apply_keff as gops
from civiwave_tpu_torch.parallel import general_halo, sharding
from civiwave_tpu_torch.utils.errors import ShardError

from chip_smoke import local_keff_general
from support import bar_config, bar_mesh
from torch_general_support import configs, to_port_packed

torch.set_num_threads(2)

OP_TOL = 1e-5
SS, MF = np.float32(1.01), np.float32(3.7)  # test_sharding.py:985
FIXTURES = {"hex": ((24, 3, 3), True), "tet": ((20, 4, 3), False)}


def _jax_fixture(dims, hex_elements, pad=64):
    """The reference's _general_fixture's packed model."""
    mesh = jsynthetic.box_mesh(*dims, hex_elements=hex_elements)
    cfg = jsynthetic.cantilever_config()
    pre = jpreprocess.run(mesh, cfg)
    mats = [jmaterials.make_properties(m) for m in cfg.materials]
    return jpack.build_packed_model(mesh, pre, cfg, mats, pad_nodes=pad,
                                    pad_elems=pad)[0]


def _x(n, seed=3):
    return np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32)


# --- the plan ----------------------------------------------------------------


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_plan_matches_the_reference(kind, shards):
    jm = _jax_fixture(*FIXTURES[kind])
    tm = to_port_packed(jm)
    ref, got = jplan(jm, shards), general_halo.plan_general_halo(tm, shards)
    assert ref is not None and got is not None
    for key in general_halo.HALO_META:  # block, L, G and E_s
        assert got[key] == ref[key], key
    for key in general_halo.HALO_ARRAYS:
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)
    assert 0 < got["halo_ghost"] <= got["halo_local_nodes"]


def _bar_model():
    mesh, cfg = bar_mesh(4, 2, 2), bar_config()
    pre = jpreprocess.run(mesh, cfg)
    mats = [jmaterials.make_properties(m) for m in cfg.materials]
    return jpack.build_packed_model(mesh, pre, cfg, mats, pad_nodes=64,
                                    pad_elems=64)[0]


def _mixed_model():
    from civiwave_tpu_torch.utils.synthetic import split_last_hex

    mesh = split_last_hex(jsynthetic.box_mesh(8, 2, 2, hex_elements=True))
    cfg = jsynthetic.cantilever_config()
    pre = jpreprocess.run(mesh, cfg)
    mats = [jmaterials.make_properties(m) for m in cfg.materials]
    return jpack.build_packed_model(mesh, pre, cfg, mats, pad_nodes=64,
                                    pad_elems=64)[0]


@pytest.mark.parametrize("name", ["bar", "mixed"])
def test_plan_is_none_where_the_reference_falls_back(name):
    """The bar's bandwidth exceeds one block at 8 shards (G > L); a mixed
    mesh has two element blocks.  Both planners decline, and the
    in-process cut refuses."""
    jm = _bar_model() if name == "bar" else _mixed_model()
    tm = to_port_packed(jm)
    assert jplan(jm, 8) is None
    assert general_halo.plan_general_halo(tm, 8) is None
    with pytest.raises(ShardError, match="no halo plan"):
        sharding.local_general_shards(tm, 8)


# --- the in-process shard operator --------------------------------------------


def _damped_tet_box():
    """A 12x3x3 tet box with dashpots on four side faces (both packages'
    meshes carry the SIDE_* groups), packed by the reference."""
    groups = ["SIDE_X1", "SIDE_Y0", "SIDE_Y1", "SIDE_Z0"]
    _, jc = configs(mesh={"path": "synthetic://box/12,3,3,tet"},
                    boundaries={"absorbing": groups})
    mesh = jsynthetic.box_mesh(12, 3, 3, side_groups=True)
    pre = jpreprocess.run(mesh, jc)
    mats = [jmaterials.make_properties(m) for m in jc.materials]
    jm = jpack.build_packed_model(mesh, pre, jc, mats, pad_nodes=32,
                                  pad_elems=32)[0]
    assert jm.has_damping
    return jm


@pytest.mark.parametrize("case", ["tet", "hex", "tet_dashpots"])
def test_in_process_shards_match_the_reference_operator(case):
    if case == "tet_dashpots":
        jm = dataclasses.replace(_damped_tet_box(), damp_factor=jnp.float32(1e3))
    else:
        jm = _jax_fixture(*FIXTURES[case])
    tm = to_port_packed(jm)
    if case == "tet_dashpots":
        tm = dataclasses.replace(tm, damp_factor=float(np.float32(1e3)))
    x = _x(tm.padded_node_count)
    ref = np.asarray(jax.jit(lambda m, v: m.apply_keff(v, SS, MF))(
        jm, jnp.asarray(x)))
    shards = sharding.local_general_shards(tm, 4)
    if case == "tet_dashpots":
        shards = [dataclasses.replace(s, damp_factor=tm.damp_factor)
                  for s in shards]
    out = torch.cat(local_keff_general(
        shards, torch.from_numpy(x), SS, MF)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0.0,
                               atol=OP_TOL * np.abs(ref).max())
    # rows off the ghost bands [s L, s L + G) sum their slots in the
    # single-device order: bit-equal to the port's unsharded operator
    plain = gops.apply_keff(tm, torch.from_numpy(x), SS, MF).numpy()
    L, G = shards[0].local_rows, shards[0].halo_ghost
    off = np.ones(tm.padded_node_count, bool)
    for s in range(1, 4):
        off[s * L:s * L + G] = False
    np.testing.assert_array_equal(out[off], plain[off])


@pytest.mark.parametrize("shards", [2, 4])
def test_row_shards_own_their_mask_rows(shards):
    """The all-gather form's shards (no plan): each rank's mask rows in a
    buffer of their own, which the fused loop's direction update reads as
    4-byte words.  At 424 padded nodes over 4 ranks a view of rank 1's rows
    would start 318 bytes in."""
    tm = to_port_packed(_jax_fixture(*FIXTURES["tet"], pad=8))
    L = tm.padded_node_count // shards
    for s in range(shards):
        local = sharding._row_shard(tm, s, shards, None)
        assert local.bc_mask.data_ptr() % 16 == 0
        assert local.bc_mask.is_contiguous()
        assert torch.equal(local.bc_mask, tm.bc_mask[s * L:(s + 1) * L])
        assert local.bc_mask.untyped_storage().data_ptr() != (
            tm.bc_mask.untyped_storage().data_ptr())


def test_convert_carries_the_reference_plan():
    """The reference's plan, attached as its shard_simulation attaches it,
    crosses ``convert``; the shards cut from it give what the port's own
    plan gives, bit for bit."""
    jm = _jax_fixture(*FIXTURES["tet"])
    plan = jplan(jm, 4)
    jm_plan = dataclasses.replace(
        jm, **{k: plan[k] for k in general_halo.HALO_META},
        **{k: jnp.asarray(plan[k]) for k in general_halo.HALO_ARRAYS})
    carried = to_port_packed(jm_plan)
    assert carried.halo_block == "tet" and carried.halo_ghost == plan["halo_ghost"]
    np.testing.assert_array_equal(carried.halo_csr_idx.numpy(),
                                  np.asarray(plan["halo_csr_idx"]))
    own = to_port_packed(jm)
    assert own.halo_conn is None
    x = torch.from_numpy(_x(own.padded_node_count, seed=5))
    got = local_keff_general(
        sharding.local_general_shards(carried, 4), x, SS, MF)
    want = local_keff_general(
        sharding.local_general_shards(own, 4), x, SS, MF)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
