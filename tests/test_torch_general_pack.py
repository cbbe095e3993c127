"""The port's packed model and general operator against the JAX package.

* pack: Dirichlet tables, lumped masses and the t = 0 load equal the
  reference's in nodal order; the dual CSR covers exactly the real
  incidences; padded elements and nodes are exact no-ops; ``to_nodal`` /
  ``from_nodal`` invert each other across the RCM permutation; absorbing
  faces pack their dashpots (ROADMAP A7-general, ported since);
* K7's plain version (``tet_forces`` / ``hex_forces``) against the
  reference's stream math (``CIVIWAVE_ELEMENT_KERNEL=xla``) and its Pallas
  tet kernel in interpret mode, on a model carried across through
  ``convert`` (same element order), at 1e-5 * max|ref|;
* the whole operator against the reference's ``apply_keff`` in nodal order
  at the BASELINE operator tolerance, and against the dense FP64 oracle.

Inputs come from seeded numpy and reach both packages as f32 arrays.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from civiwave_tpu.ops import apply_keff as jops
from civiwave_tpu_torch import convert
from civiwave_tpu_torch.mesh import pack, preprocess
from civiwave_tpu_torch.ops import apply_keff as ops
from civiwave_tpu_torch.ops.cuda import assemble_csr as g1
from civiwave_tpu_torch.ops.cuda import element_forces as k7
from civiwave_tpu_torch.physics import materials, newmark, oracle
from torch_general_support import (
    assert_operator_close,
    configs,
    model_pair,
    to_port_packed,
)

torch.set_num_threads(2)

KINDS = ["tet", "hex", "shuffled", "mixed", "column"]
SS, MF = np.float32(1.3), np.float32(2.5e5)
FORCE_TOL = 1e-5  # of max|ref|, tests/test_element_kernel.py:52


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module", params=KINDS)
def pair(request):
    return request.param, model_pair(request.param)


def test_pack_tables_match_the_reference_in_nodal_order(pair):
    _, ((pm, _, _, tm, tf), (_, _, _, jm, jf)) = pair
    assert (tm.node_count, tm.tet_count, tm.hex_count, tm.element_count) == (
        jm.node_count, jm.tet_count, jm.hex_count, jm.element_count
    )
    assert tm.csr_degree == jm.csr_degree
    for name in ("bc_mask", "bc_value", "position0"):
        np.testing.assert_array_equal(
            tm.to_nodal(getattr(tm, name)).numpy(),
            np.asarray(jm.to_nodal(getattr(jm, name))), err_msg=name,
        )
    np.testing.assert_array_equal(
        tm.to_nodal(tm.lumped_mass[:, None]).numpy()[:, 0],
        np.asarray(jm.to_nodal(jm.lumped_mass[:, None]))[:, 0],
    )
    np.testing.assert_array_equal(tm.to_nodal(tf).numpy(), np.asarray(jm.to_nodal(jf)))
    for name in ("lam", "mu", "stiffness_6x6"):
        np.testing.assert_array_equal(
            getattr(tm, name).numpy(), np.asarray(getattr(jm, name))
        )


def test_csr_covers_exactly_the_real_incidences(pair):
    _, ((_, pre, _, tm, _), _) = pair
    idx, w = tm.csr_idx.numpy(), tm.csr_weight.numpy()
    assert idx.dtype == np.int32 and tm.csr_degree % 8 == 0
    assert set(np.unique(w)) <= {0.0, 1.0}
    t4 = tm.padded_tet_count * 4
    real = w == 1.0
    rows = idx[real]
    # each real force row (tet e*4+l, hex t4 + e*8+l) exactly once
    expected = np.concatenate([
        np.arange(tm.tet_count * 4), t4 + np.arange(tm.hex_count * 8)
    ])
    np.testing.assert_array_equal(np.sort(rows), expected)
    # ... at the node its element slot names
    conn = np.concatenate([
        tm.conn_tet.numpy().reshape(-1), tm.conn_hex.numpy().reshape(-1)
    ])
    conn_rows = np.concatenate([
        np.arange(tm.padded_tet_count * 4), t4 + np.arange(tm.padded_hex_count * 8)
    ])
    node_of_row = dict(zip(conn_rows.tolist(), conn.tolist()))
    nodes = np.nonzero(real)[0]
    assert all(node_of_row[r] == n for r, n in zip(rows.tolist(), nodes.tolist()))
    assert (idx[~real] == 0).all()  # pad slots point at row 0
    assert real.sum() == pre.tet_count * 4 + pre.hex_count * 8


def test_nodal_round_trip(pair):
    _, ((_, _, _, tm, _), _) = pair
    rows = _x((tm.node_count, 3), seed=1)
    vec = tm.from_nodal(rows)
    assert vec.shape == tm.vector_shape and vec.dtype == torch.float32
    np.testing.assert_array_equal(tm.to_nodal(vec).numpy(), rows)
    # padded nodes are the internal rows past node_count (the permutation
    # has an identity tail): zero, fully constrained and massless
    assert not vec[tm.node_count:].any()
    assert bool(tm.bc_mask[tm.node_count:].all())
    assert not tm.lumped_mass[tm.node_count:].any()


def test_operator_matches_the_reference_in_nodal_order(pair):
    _, ((pmesh, _, _, tm, _), (_, _, _, jm, _)) = pair
    xn = _x((pmesh.node_count, 3), seed=2)
    ours = tm.to_nodal(ops.apply_keff(tm, tm.from_nodal(xn), SS, MF)).numpy()
    ref = np.asarray(jm.to_nodal(jops.apply_keff(jm, jm.from_nodal(xn), SS, MF)))
    assert_operator_close(ours, ref)
    # the Rayleigh-beta term's stiffness-only operator (mass_factor 0)
    ours0 = tm.to_nodal(ops.apply_keff(tm, tm.from_nodal(xn), np.float32(1), 0.0))
    ref0 = jm.to_nodal(
        jops.apply_keff(jm, jm.from_nodal(xn), np.float32(1), np.float32(0))
    )
    assert_operator_close(ours0.numpy(), np.asarray(ref0))


def test_identity_rows_and_dispatch_on_cpu(pair):
    _, ((_, _, _, tm, _), _) = pair
    x = torch.as_tensor(_x(tm.vector_shape, seed=3))
    before = (k7.tet_element_forces.launches, k7.hex_element_forces.launches,
              g1.assemble_keff.launches)
    out = ops.apply_keff(tm, x, SS, MF)
    assert torch.equal(out[tm.bc_mask], x[tm.bc_mask])
    torch.testing.assert_close(out, ops.apply_keff_plain(tm, x, SS, MF), rtol=0, atol=0)
    # the CPU takes the plain versions: no launch counted
    assert (k7.tet_element_forces.launches, k7.hex_element_forces.launches,
            g1.assemble_keff.launches) == before


@pytest.mark.parametrize("kind", KINDS)
def test_element_forces_plain_match_the_reference_stream_math(kind, monkeypatch):
    monkeypatch.setenv("CIVIWAVE_ELEMENT_KERNEL", "xla")
    _, (_, _, _, jm, _) = model_pair(kind)
    tm = to_port_packed(jm)
    x = _x(tm.vector_shape, seed=4)
    xs_j = jops.sanitize(jm, jnp.asarray(x))
    xs_t = ops.sanitize(tm, torch.as_tensor(x))
    for block, count in (("tet", tm.padded_tet_count), ("hex", tm.padded_hex_count)):
        if not count:
            continue
        ref = np.asarray(getattr(jops, f"{block}_forces")(jm, xs_j, SS))
        ours = getattr(ops, f"{block}_forces")(tm, xs_t, SS).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=FORCE_TOL * np.abs(ref).max())
        # the wrapper's plain path (raw x in, sanitized inside) is the same
        wrapper = k7.tet_element_forces if block == "tet" else k7.hex_element_forces
        np.testing.assert_array_equal(
            wrapper(tm, torch.as_tensor(x), SS).numpy(), ours
        )
    # the whole plain operator on the carried-across model, same order
    ref = np.asarray(jops.apply_keff(jm, jnp.asarray(x), SS, MF))
    assert_operator_close(ops.apply_keff(tm, torch.as_tensor(x), SS, MF).numpy(), ref)


def test_tet_forces_match_the_pallas_kernel_in_interpret_mode(monkeypatch):
    """9^3 tet box: 4374 tets, which the reference pads to 2 * 4096 so its
    tet force phase runs the Pallas kernel (here interpreted); the carried
    model keeps that padding."""
    from civiwave_tpu.mesh import pack as jpack
    from civiwave_tpu.mesh import preprocess as jpreprocess
    from civiwave_tpu.physics import materials as jmaterials
    from civiwave_tpu.utils.synthetic import box_mesh as jbox

    _, jc = configs()
    jmesh = jbox(9, 9, 9)
    jm, _, _ = jpack.build_packed_model(
        jmesh, jpreprocess.run(jmesh, jc), jc,
        [jmaterials.make_properties(m) for m in jc.materials],
    )
    assert jm.padded_tet_count == 8192
    tm = to_port_packed(jm)
    x = _x(tm.vector_shape, seed=5)
    monkeypatch.setenv("CIVIWAVE_ELEMENT_KERNEL", "interpret")
    xs = jops.sanitize(jm, jnp.asarray(x))
    ref = np.asarray(jops.tet_forces(jm, xs, np.float32(1)))
    ours = k7.tet_element_forces(tm, torch.as_tensor(x), np.float32(1)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=FORCE_TOL * np.abs(ref).max())
    # padded elements are exact no-ops: their force rows are zero
    assert not ours[jm.tet_count * 4:].any()


def test_padding_is_an_exact_no_op():
    (pmesh, pre, cfg, tm, _), _ = model_pair("mixed")
    mats = [materials.make_properties(m) for m in cfg.materials]
    big, _, _ = pack.build_packed_model(
        pmesh, pre, cfg, mats, pad_nodes=64, pad_elems=64, device="cpu"
    )
    assert big.padded_node_count % 64 == 0 and big.padded_hex_count % 64 == 0
    assert big.padded_hex_count > big.hex_count
    xn = _x((pmesh.node_count, 3), seed=6)
    a = tm.to_nodal(ops.apply_keff(tm, tm.from_nodal(xn), SS, MF))
    b = big.to_nodal(ops.apply_keff(big, big.from_nodal(xn), SS, MF))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    rows = ops.element_force_rows(big, ops.sanitize(big, big.from_nodal(xn)), SS)
    t4 = big.padded_tet_count * 4
    assert not rows[big.tet_count * 4:t4].any()
    assert not rows[t4 + big.hex_count * 8:].any()


def test_absorbing_faces_raise_a7():
    """Absorbing faces used to raise here (ROADMAP A7-general); the general
    path now packs their dashpots, zero on padded nodes."""
    cfg, _ = configs(
        mesh={"path": "synthetic://box/3,3,3,tet"},
        boundaries={"absorbing": ["SIDE_X1"]},
    )
    from civiwave_tpu_torch.utils.synthetic import box_mesh

    mesh = box_mesh(3, 3, 3, side_groups=True)
    pre = preprocess.run(mesh, cfg)
    model, _, _ = pack.build_packed_model(
        mesh, pre, cfg, [materials.make_properties(m) for m in cfg.materials],
        device="cpu",
    )
    assert model.has_damping and model.damp_blocks.shape == (model.padded_node_count, 6)
    x1 = np.isclose(mesh.node_positions[:, 0], 3.0)
    rows = model.damp_blocks[model.perm_new_of_old] if model.renumbered else model.damp_blocks
    assert rows[: mesh.node_count][torch.from_numpy(x1)].abs().sum(1).gt(0).all()
    assert not rows[: mesh.node_count][torch.from_numpy(~x1)].any()


def test_convert_refuses_unported_fields():
    _, (_, _, _, jm, _) = model_pair("tet")
    tm = to_port_packed(jm)
    assert tm.padded_tet_count == jm.padded_tet_count
    arrays = {name: np.asarray(getattr(jm, name)) for name in convert.PACKED_ARRAYS}
    meta = {name: getattr(jm, name) for name in convert.PACKED_META}
    damped = convert.packed_model_from_arrays(
        {**arrays, "damp_blocks": np.ones((jm.padded_node_count, 6))},
        meta, "cpu",
    )
    assert damped.has_damping and not tm.has_damping
    # the halo tables are carried now (test_torch_general_sharded), all of
    # them with their scalars, or none
    with pytest.raises(ValueError, match="halo"):
        convert.packed_model_from_arrays(
            {**arrays, "halo_conn": np.zeros((8, 4), np.int32)}, meta, "cpu"
        )
    from civiwave_tpu.parallel.general_halo import plan_general_halo as jplan

    plan = jplan(jm, 2)
    carried = convert.packed_model_from_arrays(
        {**arrays, **{k: plan[k] for k in convert.PACKED_HALO}},
        {**meta, **{k: plan[k] for k in convert.PACKED_HALO_META}}, "cpu")
    assert (carried.halo_block, carried.halo_local_nodes, carried.halo_ghost,
            carried.halo_elems) == tuple(plan[k] for k in convert.PACKED_HALO_META)
    for name in convert.PACKED_HALO:
        np.testing.assert_array_equal(getattr(carried, name).numpy(), plan[name])


@pytest.mark.parametrize("hex_elements", [False, True], ids=["tet", "hex"])
def test_operator_matches_the_dense_oracle(hex_elements):
    """K_eff x of the port against the dense FP64 oracle (the port's own
    copy of physics/oracle.py) at the BASELINE operator tolerance."""
    from civiwave_tpu_torch.utils.synthetic import box_mesh

    cfg, _ = configs()
    mesh = box_mesh(3, 2, 2, hex_elements=hex_elements)
    pre = preprocess.run(mesh, cfg)
    mats = [materials.make_properties(m) for m in cfg.materials]
    model, _, _ = pack.build_packed_model(mesh, pre, cfg, mats, device="cpu")
    ray = materials.compute_rayleigh(cfg.damping)
    coeffs = newmark.make_coefficients(0.01)
    assembly = oracle.assemble_linear_system(mesh, pre, mats)
    dirichlet = oracle.build_dirichlet_conditions(mesh, cfg)
    ss = 1.0 + coeffs.a1 * ray.beta
    mf = coeffs.a0 + coeffs.a1 * ray.alpha
    xn = _x((mesh.node_count, 3), seed=7) * np.float32(0.01)
    got = model.to_nodal(
        ops.apply_keff(model, model.from_nodal(xn), np.float32(ss), np.float32(mf))
    ).numpy().reshape(-1)
    x = xn.reshape(-1).astype(np.float64)
    x_san = np.where(dirichlet.mask, 0.0, x)
    ref = ss * (assembly.stiffness @ x_san) + mf * assembly.mass_diag * x_san
    ref = np.where(dirichlet.mask, x, ref)
    assert_operator_close(got, ref)
