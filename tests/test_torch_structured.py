"""Structured model and operator of the port against the JAX reference.

* the builder's fields equal the reference's bit for bit (fixes on several
  faces, +X dead pad planes, extents of 1);
* the plain operator (``apply_keff_structured_plain``) equals the reference
  ``apply_keff`` (XLA form) and the Pallas kernel in interpret mode;
* the per-boundary-class stencil table that the CUDA kernels K1/K2 read is
  checked here through a numpy emulation of the kernels' arithmetic
  (one node at a time: 27 sanitized neighbours times its class's taps), since
  the CUDA kernels themselves run only on a GPU.

Inputs come from seeded numpy and reach both packages as f32 arrays.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from civiwave_tpu.mesh import structured as jstructured
from civiwave_tpu.mesh.structured_config import try_build_structured as jtry_build
from civiwave_tpu.ops import structured as jops
from civiwave_tpu.ops.pallas.structured_stencil import apply_keff_fused_pallas
from civiwave_tpu.physics import materials as jmaterials
from civiwave_tpu_torch import convert
from civiwave_tpu_torch.mesh import structured as tstructured
from civiwave_tpu_torch.mesh.structured_config import try_build_structured
from civiwave_tpu_torch.ops import structured as tops
from civiwave_tpu_torch.ops.cuda import structured_stencil as k12
from civiwave_tpu_torch.utils.synthetic import cantilever_config

torch.set_num_threads(2)

CPU = torch.device("cpu")
OP_TOL = 1e-5  # atol = 1e-5 * max|ref| (tests/test_structured.py:348)
SS, MF = np.float32(1.3), np.float32(2.5e5)

CASES = {
    "plain": ((5, 4, 3), {}),
    "fixes": ((5, 4, 3), dict(fixes=[
        ("x0", (True, True, True), (None, None, None)),
        ("z1", (True, False, True), (1e-3, None, -2e-3)),
        ("y0", (False, True, False), (None, None, None)),
    ])),
    "xpad": ((6, 5, 4), dict(pad_x_multiple=4, fixed_axis_planes=("x0", "z1"))),
    "nx1": ((1, 3, 2), {}),
    "ny1_nz1": ((3, 1, 1), dict(fixed_axis_planes=("x0", "x1"))),
    "spacing_gravity_ztraction": ((4, 3, 5), dict(
        spacing=(0.3, 0.7, 1.1), gravity=(1.0, 2.0, -9.81),
        traction=(1e5, -2e5, 3e5), traction_plane="z1",
    )),
}

JAX_ARRAYS = tuple(convert.STRUCTURED_ARRAYS)


def material():
    cfg = cantilever_config()
    return cfg.materials[0]


def build_pair(dims, kw):
    """(jax model, jax force, port model, port force) from one spec."""
    mat = material()
    jm, jf = jstructured.build_structured_model(
        *dims, jmaterials.make_properties(mat), mat.density, **kw
    )
    from civiwave_tpu_torch.physics import materials as tmaterials

    tm, tf = tstructured.build_structured_model(
        *dims, tmaterials.make_properties(mat), mat.density, device=CPU, **kw
    )
    return jm, jf, tm, tf


def to_port(jm):
    """The JAX model handed over through convert (same arrays, same meta)."""
    arrays = {name: np.asarray(getattr(jm, name)) for name in JAX_ARRAYS}
    meta = {name: getattr(jm, name) for name in convert.STRUCTURED_META}
    meta.update(pad_rows=jm.pad_rows, homogeneous=jm.homogeneous)
    return convert.structured_model_from_arrays(arrays, meta, CPU)


def emulate_keff(model, x, ss, mf):
    """numpy emulation of the K1 kernel: per node, 27 sanitized neighbours
    (zero outside the grid) times the node's class stencil, mass from m8
    and the class weights, identity rows by select."""
    table = model.stencil_table.numpy().astype(np.float64)
    bc = model.bc_mask.numpy()
    _, X, Y, Z = x.shape
    xs = np.where(bc, 0.0, x).astype(np.float64)
    xp = np.pad(xs, ((0, 0), (1, 1), (1, 1), (1, 1)))
    cx = tops.axis_classes(X, model.nx)
    cy = tops.axis_classes(Y, model.ny)
    cz = tops.axis_classes(Z, model.nz)
    cls = (cx[:, None, None] * 3 + cy[None, :, None]) * 3 + cz[None, None, :]
    acc = np.zeros((3, X, Y, Z))
    for d in np.ndindex(3, 3, 3):
        win = xp[:, d[0]:d[0] + X, d[1]:d[1] + Y, d[2]:d[2] + Z]
        blk = table[cls, (d[0] * 3 + d[1]) * 3 + d[2]]  # (X, Y, Z, 3, 3)
        acc += np.einsum("xyzbc,cxyz->bxyz", blk, win)

    def weight(c):
        return np.where(c == 1, 1.0, 0.5)

    mass = (model.m8 * weight(cx)[:, None, None] * weight(cy)[None, :, None]
            * weight(cz)[None, None, :])
    return np.where(bc, x, float(ss) * acc + float(mf) * mass * xs)


def _assert_close(out, ref, rel):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale = np.abs(ref).max() + 1e-30
    np.testing.assert_allclose(out, ref, rtol=0.0, atol=rel * scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_builder_fields_bitwise(case):
    dims, kw = CASES[case]
    jm, jf, tm, tf = build_pair(dims, kw)
    for name in JAX_ARRAYS:
        a = getattr(tm, name).numpy()
        b = np.asarray(getattr(jm, name))
        assert a.shape == b.shape, name
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    for name in convert.STRUCTURED_META:
        assert getattr(tm, name) == getattr(jm, name), name
    from civiwave_tpu.ops.pallas.structured_stencil import _interior_mass

    assert np.float32(tm.m8) == np.float32(_interior_mass(jm))
    assert tm.vector_shape == jm.vector_shape
    # the convert hand-over carries the same model
    tc = to_port(jm)
    for name in JAX_ARRAYS:
        assert torch.equal(getattr(tc, name), getattr(tm, name)), name
    assert tc.m8 == tm.m8 and torch.equal(tc.stencil_table, tm.stencil_table)


@pytest.mark.parametrize("case", sorted(CASES))
def test_operator_matches_reference(case):
    dims, kw = CASES[case]
    jm, _, tm, _ = build_pair(dims, kw)
    x = np.random.default_rng(7).standard_normal(jm.vector_shape).astype(np.float32)
    ref = np.asarray(jm.apply_keff(jnp.asarray(x), SS, MF))
    plain = tm.apply_keff(torch.from_numpy(x), SS, MF).numpy()
    _assert_close(plain, ref, OP_TOL)
    # identity rows pass the raw input through, bit for bit
    bc = tm.bc_mask.numpy()
    np.testing.assert_array_equal(plain[bc], x[bc])
    # the class-table arithmetic of the K1 kernel
    _assert_close(emulate_keff(tm, x, SS, MF), ref, OP_TOL)


def test_class_table_equals_inclusion_exclusion():
    """The interior class carries the interior stencil; the low-x face
    class has no taps into the missing plane x-1 and the x0 face slab
    subtracted at dx = 0 (the ghost cells below x = 0 couple the boundary
    node only with its own plane)."""
    spacing, lam0, mu0 = (0.5, 1.0, 2.0), 1.1e11, 7.7e10
    table = tops.class_stencil_table(spacing, lam0, mu0).reshape(
        3, 3, 3, 3, 3, 3, 3, 3
    )
    interior, faces, _, _ = tops._stencil_tables(spacing, lam0, mu0)
    atol = 1e-6 * np.abs(interior).max()
    np.testing.assert_allclose(table[1, 1, 1], interior, rtol=0, atol=atol)
    low = table[0, 1, 1]
    assert np.all(low[0] == 0.0)
    np.testing.assert_allclose(
        low[1], interior[1] - faces[(0, 0)], rtol=0, atol=atol
    )
    np.testing.assert_allclose(low[2], interior[2], rtol=0, atol=atol)
    # rigid translations are in the kernel of every class's stencil
    sums = table.reshape(27, 27, 3, 3).sum(axis=1)
    assert np.abs(sums).max() <= 1e-6 * np.abs(interior).max()


def test_to_from_nodal_and_traction_grid_match():
    dims, kw = CASES["xpad"]
    jm, _, tm, _ = build_pair(dims, kw)
    rows = np.random.default_rng(3).standard_normal((jm.node_count, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tm.from_nodal(rows).numpy(), np.asarray(jm.from_nodal(rows))
    )
    vec = tm.from_nodal(rows)
    np.testing.assert_array_equal(
        tm.to_nodal(vec).numpy(), np.asarray(jm.to_nodal(jnp.asarray(vec.numpy())))
    )
    value = (1e5, -2e5, 3e5)
    np.testing.assert_array_equal(
        tstructured.traction_force_grid(tm, "x1", value),
        jstructured.traction_force_grid(jm, "x1", value),
    )
    jp, _, tp, _ = build_pair(dims, {})  # the reference needs no X pad here
    xs = tp.grid_shape[0]
    for tag in ("z1", "y0"):
        ref = jstructured.traction_force_grid(jp, tag, value)
        np.testing.assert_array_equal(
            tstructured.traction_force_grid(tp, tag, value), ref
        )
        padded = tstructured.traction_force_grid(tm, tag, value)
        np.testing.assert_array_equal(padded[:, :xs], ref)
        assert not padded[:, xs:].any()


def test_pallas_interpret_kernel_matches_plain():
    """The reference's fused Pallas K_eff (interpret mode) against the
    port's plain operator and the K1 emulation on one grid with a pad."""
    dims, kw = CASES["xpad"]
    jm, _, tm, _ = build_pair(dims, kw)
    x = np.random.default_rng(11).standard_normal(jm.vector_shape).astype(np.float32)
    tables = jops._stencil_tables(jm.spacing, jm.lam0, jm.mu0)
    ref = np.asarray(apply_keff_fused_pallas(
        jm, jnp.asarray(x), jnp.float32(SS), MF, tables, interpret=True
    ))
    _assert_close(tm.apply_keff(torch.from_numpy(x), SS, MF).numpy(), ref, OP_TOL)
    _assert_close(emulate_keff(tm, x, SS, MF), ref, OP_TOL)


def test_try_build_structured_matches_reference():
    from civiwave_tpu.utils.synthetic import cantilever_config as jcantilever

    node = dict(
        mesh={"path": "synthetic://box/6,3,4"},
        loads={"gravity": [0.0, 0.0, -9.81], "tractions": [
            {"group": "LOAD_FACE", "value": [0.0, 0.0, -2e5], "scale_curve": "ramp"},
            {"group": "SIDE_Z1", "value": [1e4, 0.0, 0.0]},
        ]},
        curves={"ramp": [[0.0, 0.0], [0.05, 1.0]]},
    )
    ours = try_build_structured(cantilever_config(**node), device=CPU)
    ref = jtry_build(jcantilever(**node))
    (tm, tsched), (jm, jsched) = ours, ref
    for name in JAX_ARRAYS:
        np.testing.assert_array_equal(
            getattr(tm, name).numpy(), np.asarray(getattr(jm, name))
        )
    cfg = cantilever_config(**node)
    for t in (0.0, 0.013, 0.05, 0.2):
        np.testing.assert_array_equal(
            tsched.at_time(cfg.curves, t).numpy(),
            np.asarray(jsched.at_time(cfg.curves, t)),
        )


@pytest.mark.parametrize(
    "node",
    [
        # multigrid is ported since: the scenario builds with its hierarchy
        dict(solver={"type": "pcg", "preconditioner": "multigrid",
                     "tol_runtime": 1e-4, "tol_pause": 1e-5, "max_iters": 10},
             mesh={"path": "synthetic://box/8,4,4"}),
        # absorbing faces on a tet box take the general path, which has
        # ported them: the build succeeds with the dashpots packed
        dict(boundaries={"absorbing": ["SIDE_X1"]},
             mesh={"path": "synthetic://box/3,2,2,tet"}),
    ],
    ids=["multigrid", "absorbing"],
)
def test_unported_scenarios_raise(node):
    from civiwave_tpu_torch.runner import build_simulation

    cfg = cantilever_config(**{"mesh": {"path": "synthetic://box/3,2,2"}, **node})
    model = build_simulation(cfg, device="cpu").model  # ported since: it builds
    if cfg.solver.preconditioner == "multigrid":
        assert model.multigrid and len(model.mg_levels) == 1
    else:
        assert model.has_damping


def test_general_path_scenarios_are_not_routed():
    for path in ("column.msh", "synthetic://box/3,2,2,tet"):
        assert try_build_structured(
            cantilever_config(mesh={"path": path}), device=CPU
        ) is None


def test_kernel_wrappers_refuse_other_devices():
    dims, kw = CASES["plain"]
    _, _, tm, _ = build_pair(dims, kw)
    x = torch.zeros(tm.vector_shape, device="meta")
    with pytest.raises(ValueError):
        k12.apply_keff_fused(tm, x, SS, MF)
    with pytest.raises(ValueError):
        k12.apply_pc_keff_fused(tm, torch.zeros(6, 3, 3, 3), x, SS, MF)
