"""Absorbing faces on the port's general gather path against the JAX
reference.

* ``physics/absorbing.py``: ``assemble_dashpots`` bit-equal to the
  reference's on tet and hex boxes, ``sym_apply`` on numpy arrays and
  torch tensors, ``dense_damping_matrix``;
* the packed model carries the dashpots (``damp_blocks``, ``has_damping``)
  equal to the reference's in nodal order, and ``convert`` carries them;
* the general operator with the dashpot term (``damp_factor`` = Newmark a1)
  on a 4x4x2 tet basin against the reference's ``apply_keff`` on the same
  model (through ``convert``) at the BASELINE operator tolerance, against
  the dense FP64 oracle ``K_eff + a1 C``, and without a term outside a
  step; ``absorbing_force`` against the reference's; the node-block
  Jacobi leaves the dashpots out, as the reference's does;
* 5 stepped frames of ``examples/seismic_basin.yaml`` meshed with tets
  against the reference runner: iterations within +-1, u at 2.5e-4 and a
  at 3e-3 of max|ref|; and its CLI run with ``--output``.

Inputs come from seeded numpy and reach both packages as f32 arrays.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from civiwave_tpu.physics import absorbing as jabsorbing
from civiwave_tpu.runner import build_simulation as jbuild_simulation
from civiwave_tpu.runner import main as jmain
from civiwave_tpu_torch import convert
from civiwave_tpu_torch.mesh import pack, preprocess
from civiwave_tpu_torch.ops import apply_keff as ops
from civiwave_tpu_torch.physics import absorbing, materials, oracle
from civiwave_tpu_torch.runner import build_simulation, main
from civiwave_tpu_torch.solver.stepper import effective_scalars

from torch_general_support import (
    U_TOL,
    A_TOL,
    assert_operator_close,
    configs,
    to_port_packed,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASIN_YAML = os.path.join(REPO, "examples", "seismic_basin.yaml")
FIVE = ["SIDE_X0", "SIDE_X1", "SIDE_Y0", "SIDE_Y1", "SIDE_Z0"]
DT = 2e-3
SS, MF = effective_scalars(DT, 0.0909, 3.64e-4)
A1 = float(np.float32(0.5 / (0.25 * DT)))  # the Newmark a1 the stepper sets


def basin_pair(nx, ny, nz, hex_elements=False, absorbing_groups=FIVE):
    """Both packages' (mesh, preprocess, config, materials, model) of the
    steel cantilever box with absorbing side faces."""
    from civiwave_tpu.mesh import pack as jpack
    from civiwave_tpu.mesh import preprocess as jpreprocess
    from civiwave_tpu.physics import materials as jmaterials
    from civiwave_tpu.utils import synthetic as jsynthetic
    from civiwave_tpu_torch.utils import synthetic

    spec = f"synthetic://box/{nx},{ny},{nz}{',hex' if hex_elements else ',tet'}"
    pc, jc = configs(mesh={"path": spec},
                     boundaries={"absorbing": list(absorbing_groups)})
    out = []
    for syn, pre_mod, mat_mod, pk, cfg, kw in (
        (synthetic, preprocess, materials, pack, pc, dict(device="cpu")),
        (jsynthetic, jpreprocess, jmaterials, jpack, jc, {}),
    ):
        mesh = syn.box_mesh(nx, ny, nz, hex_elements=hex_elements, side_groups=True)
        pre = pre_mod.run(mesh, cfg)
        mats = [mat_mod.make_properties(m) for m in cfg.materials]
        model = pk.build_packed_model(mesh, pre, cfg, mats, **kw)[0]
        out.append((mesh, pre, cfg, mats, model))
    return out


@pytest.fixture(scope="module")
def tet_basin():
    return basin_pair(4, 4, 2)


def _x(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 1e-3).astype(
        np.float32)


@pytest.mark.parametrize("hex_elements", [False, True], ids=["tet", "hex"])
def test_assemble_dashpots_bit_equal(hex_elements):
    (tmesh, tpre, tcfg, tmats, _), (jmesh, jpre, jcfg, jmats, _) = basin_pair(
        3, 4, 2, hex_elements)
    got = absorbing.assemble_dashpots(tmesh, tpre, tcfg, tmats)
    ref = jabsorbing.assemble_dashpots(jmesh, jpre, jcfg, jmats)
    assert got.shape == (tmesh.node_count, 6) and got.dtype == np.float64
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got).max() > 0.0


def test_assemble_dashpots_without_groups_is_none(tet_basin):
    (mesh, pre, cfg, mats, _), _ = tet_basin
    assert absorbing.assemble_dashpots(
        mesh, pre, dataclasses.replace(cfg, absorbing=[]), mats) is None


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_sym_apply_matches_reference(kind):
    rng = np.random.default_rng(1)
    packed = rng.standard_normal((10, 6)).astype(np.float32)
    v = rng.standard_normal((10, 3)).astype(np.float32)
    ref = np.asarray(jabsorbing.sym_apply(jnp.asarray(packed), jnp.asarray(v)))
    if kind == "torch":
        got = absorbing.sym_apply(torch.from_numpy(packed), torch.from_numpy(v)).numpy()
    else:
        got = absorbing.sym_apply(packed, v)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    dense = absorbing.dense_damping_matrix(packed.astype(np.float64))
    np.testing.assert_allclose(got.reshape(-1), dense @ v.reshape(-1).astype(np.float64),
                               rtol=1e-5, atol=1e-5)


def test_dense_damping_matrix_matches_reference():
    packed = np.random.default_rng(2).standard_normal((5, 6))
    np.testing.assert_array_equal(absorbing.dense_damping_matrix(packed),
                                  jabsorbing.dense_damping_matrix(packed))
    blocks = np.random.default_rng(3).standard_normal((4, 3, 3))
    blocks = blocks + blocks.transpose(0, 2, 1)
    np.testing.assert_array_equal(absorbing.sym_pack(blocks),
                                  jabsorbing.sym_pack(blocks))
    assert absorbing.wave_speeds(1e9, 2e9, 2000.0) == jabsorbing.wave_speeds(
        1e9, 2e9, 2000.0)


def test_pack_carries_the_dashpots(tet_basin):
    (tmesh, _, _, _, tm), (_, _, _, _, jm) = tet_basin
    assert tm.has_damping and jm.has_damping
    n = tmesh.node_count
    ours = tm.damp_blocks if tm.perm_new_of_old is None else tm.damp_blocks[
        tm.perm_new_of_old]
    ref = np.asarray(jm.damp_blocks)
    if jm.perm_new_of_old is not None:
        ref = ref[np.asarray(jm.perm_new_of_old)]
    np.testing.assert_array_equal(ours[:n].numpy(), ref[:n])
    assert not tm.damp_blocks[n:].any()
    (_, _, _, _, plain), _ = basin_pair(2, 2, 2, absorbing_groups=())
    assert plain.damp_blocks is None and not plain.has_damping
    assert not plain.absorbing_force(torch.ones(plain.vector_shape)).any()


def test_convert_carries_damp_blocks(tet_basin):
    _, (_, _, _, _, jm) = tet_basin
    tm = to_port_packed(jm)
    assert tm.has_damping
    np.testing.assert_array_equal(tm.damp_blocks.numpy(), np.asarray(jm.damp_blocks))
    arrays = {name: np.asarray(getattr(jm, name)) for name in convert.PACKED_ARRAYS}
    meta = {name: getattr(jm, name) for name in convert.PACKED_META}
    with pytest.raises(ValueError, match="has_damping"):
        convert.packed_model_from_arrays(arrays, {**meta, "has_damping": True}, "cpu")


def test_operator_with_dashpots_matches_reference(tet_basin):
    """Same model in both packages (carried through convert): K_eff x with
    + a1 C xs on free rows."""
    _, (_, _, _, _, jm) = tet_basin
    tm = to_port_packed(jm)
    x = _x(jm.vector_shape, seed=4)
    jd = dataclasses.replace(jm, damp_factor=jnp.float32(A1))
    td = dataclasses.replace(tm, damp_factor=A1)
    ref = np.asarray(jd.apply_keff(jnp.asarray(x), SS, MF))
    got = td.apply_keff(torch.from_numpy(x), SS, MF).numpy()
    assert_operator_close(got, ref)
    # the term is there: without damp_factor the operator differs
    plain = tm.apply_keff(torch.from_numpy(x), SS, MF).numpy()
    assert np.abs(plain - got).max() > 1e-3 * np.abs(got).max()


def test_operator_with_dashpots_matches_dense_oracle(tet_basin):
    """The port's own pack, in nodal order, against K_eff + a1 C assembled
    densely in f64 (identity rows on constrained axes)."""
    (mesh, pre, cfg, mats, tm), _ = tet_basin
    n = mesh.node_count
    assembly = oracle.assemble_linear_system(mesh, pre, mats)
    mask = oracle.build_dirichlet_conditions(mesh, cfg).mask
    c = absorbing.dense_damping_matrix(absorbing.assemble_dashpots(mesh, pre, cfg, mats))
    xn = _x((n, 3), seed=5)
    x = xn.reshape(-1).astype(np.float64)
    x_san = np.where(mask, 0.0, x)
    ref = (float(SS) * (assembly.stiffness @ x_san)
           + float(MF) * assembly.mass_diag * x_san)
    ref = np.where(mask, x, ref + np.where(mask, 0.0, A1 * (c @ x_san)))
    td = dataclasses.replace(tm, damp_factor=A1)
    got = td.to_nodal(td.apply_keff(td.from_nodal(xn), SS, MF))
    assert_operator_close(got.numpy().reshape(-1), ref)


def test_absorbing_force_matches_reference(tet_basin):
    _, (_, _, _, _, jm) = tet_basin
    tm = to_port_packed(jm)
    v = _x(jm.vector_shape, seed=6)
    ref = np.asarray(jm.absorbing_force(jnp.asarray(v)))
    got = tm.absorbing_force(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    assert not got[tm.bc_mask.numpy()].any()


def test_dashpot_term_counts_and_needs_a_step(tet_basin):
    """Outside a step (damp_factor None) the operator has no term; each
    application inside one is counted."""
    (_, _, _, _, tm), _ = tet_basin
    x = torch.from_numpy(_x(tm.vector_shape, seed=7))
    before = ops.add_dashpot_term.calls
    out = ops.apply_keff_plain(tm, x, SS, MF)
    assert ops.add_dashpot_term.calls == before
    torch.testing.assert_close(out, ops.finish_keff(
        tm, ops.assemble(tm, ops.element_force_rows(tm, ops.sanitize(tm, x), SS)),
        x, MF), rtol=0, atol=0)
    ops.apply_keff_plain(dataclasses.replace(tm, damp_factor=A1), x, SS, MF)
    assert ops.add_dashpot_term.calls == before + 1


def test_preconditioner_leaves_the_dashpots_out(tet_basin):
    (_, _, _, _, tm), (_, _, _, _, jm) = tet_basin
    (_, _, _, _, plain), _ = basin_pair(4, 4, 2, absorbing_groups=())
    ours = tm.build_preconditioner(SS, MF)
    assert torch.equal(ours, plain.build_preconditioner(SS, MF))
    ref = np.asarray(jm.build_preconditioner(SS, MF))
    perm = lambda m: (np.arange(m.padded_node_count) if m.perm_new_of_old is None
                      else np.asarray(m.perm_new_of_old))
    np.testing.assert_allclose(ours.numpy()[perm(tm)][:tm.node_count],
                               ref[perm(jm)][:tm.node_count], rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def _tet_basin_yaml(tmp_path, spec="6,6,3,tet"):
    text = open(BASIN_YAML, encoding="utf-8").read()
    assert "synthetic://box/48,48,24" in text
    path = tmp_path / "basin_tet.yaml"
    path.write_text(text.replace("synthetic://box/48,48,24", f"synthetic://box/{spec}"))
    return str(path)


def test_tet_basin_frames_match_reference(tmp_path):
    """examples/seismic_basin.yaml meshed with tets (general path, five
    absorbing faces) for 5 frames, in nodal order."""
    path = _tet_basin_yaml(tmp_path)
    sim, jsim = build_simulation(path, device="cpu"), jbuild_simulation(path)
    assert not sim.structured and sim.model.has_damping
    tel, jtel = sim.run(5), jsim.run(5)
    iters = [t.pcg_iterations for t in tel]
    jiters = [t.pcg_iterations for t in jtel]
    assert all(abs(a - b) <= 1 for a, b in zip(iters, jiters)), (iters, jiters)
    assert sum(iters) > 0 and all(t.pcg_converged for t in tel)
    for ours, ref, tol in (
        (sim.stepper.displacement(), jsim.stepper.displacement(), U_TOL),
        (sim.stepper.acceleration(), jsim.stepper.acceleration(), A_TOL),
    ):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours, ref, rtol=0.0, atol=tol * np.abs(ref).max())


def test_tet_basin_cli_output_matches_reference(tmp_path):
    path = _tet_basin_yaml(tmp_path, "4,4,2,tet")
    ours, ref = tmp_path / "port", tmp_path / "ref"
    assert main([path, "--frames", "5", "--quiet", "--device", "cpu",
                 "--output", str(ours)]) == 0
    assert jmain([path, "--frames", "5", "--quiet", "--output", str(ref)]) == 0
    assert sorted(os.listdir(ours / "vtu")) == sorted(os.listdir(ref / "vtu"))
    got = np.loadtxt(ours / "probes" / "probes.csv", delimiter=",", skiprows=1)
    want = np.loadtxt(ref / "probes" / "probes.csv", delimiter=",", skiprows=1)
    assert got.shape == want.shape == (5, 25)
    for cols, tol in ((slice(3, 6), U_TOL), (slice(6, 25), A_TOL)):
        np.testing.assert_allclose(got[:, cols], want[:, cols], rtol=0.0,
                                   atol=tol * np.abs(want[:, cols]).max())
