"""The slender-member route of the port (K4 + G2) against the JAX reference.

* the plain K4 (``interior_stencil``) against the reference's Pallas kernel
  ``interior_stencil_pallas`` in interpret mode, on grids with +X pad
  planes, an n = 1 axis and odd sizes, at 1e-5 * max|ref|;
* the split operator (sanitize -> K4 -> G2), forced onto small models by
  lowering the node threshold as the reference's tests/test_structured.py
  does, against the reference ``apply_keff`` at the BASELINE operator
  tolerance max(1e-4, 3e-4 * |ref|) per DOF and at 1e-5 * max|ref|;
* G2's ghost-tap table, and a numpy emulation of G2's arithmetic (node by
  node: the class's ghost taps on the sanitized neighbours), against the
  plain G2, since the CUDA kernel runs only on a GPU;
* the route table by shape, and what declines on the route (K2, its dots,
  the whole-iteration bundle);
* 10 frames of a small soil column on the forced route against the
  reference runner, 'classic' and 'fused': iterations +-1, u at 2.5e-4 and
  a at 3e-3 of max|ref|.

Inputs come from seeded numpy and reach both packages as f32 arrays.
"""

import json
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from civiwave_tpu.ops import structured as jops
from civiwave_tpu.ops.pallas.structured_stencil import interior_stencil_pallas
from civiwave_tpu.runner import build_simulation as jbuild_simulation
from civiwave_tpu_torch.ops import structured as tops
from civiwave_tpu_torch.ops.cuda import interior_stencil as k4
from civiwave_tpu_torch.ops.cuda import keff_boundary as g2
from civiwave_tpu_torch.ops.cuda import structured_stencil as k12
from civiwave_tpu_torch.runner import build_simulation
from civiwave_tpu_torch.solver.stepper import effective_scalars
from civiwave_tpu_torch.utils.synthetic import soil_column_config

from test_torch_structured import CASES, build_pair

torch.set_num_threads(2)

OP_TOL = 1e-5
U_TOL, A_TOL = 2.5e-4, 3e-3
SS, MF = effective_scalars(2e-3, 0.0909, 3.64e-4)

K4_GRIDS = {
    "xpad": ((6, 5, 4), dict(pad_x_multiple=4)),
    "nx1": ((1, 3, 2), {}),
    "odd": ((5, 3, 7), {}),
}


def _x(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_close(out, ref, rel=OP_TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0.0,
                               atol=rel * (np.abs(ref).max() + 1e-30))


@pytest.fixture
def forced(monkeypatch):
    """Every grid takes the slender route (the threshold the reference's
    own test lowers); the plane floor keeps small grids non-profitable."""
    monkeypatch.setattr(tops, "_FLAT_INTERIOR_NODE_THRESHOLD", 0)


@pytest.mark.parametrize("case", sorted(K4_GRIDS))
def test_plain_k4_matches_pallas_interpret(case):
    dims, kw = K4_GRIDS[case]
    jm, _, tm, _ = build_pair(dims, kw)
    # K4 takes the sanitized vector: the dead pad planes read as zero
    xs = np.where(np.asarray(jm.bc_mask), 0.0, _x(jm.vector_shape)).astype(np.float32)
    taps = jops._stencil_tables(jm.spacing, jm.lam0, jm.mu0)[0]
    ref = np.asarray(interior_stencil_pallas(jnp.asarray(xs), taps, interpret=True))
    out = k4.interior_stencil(torch.from_numpy(xs), tops.interior_taps(tm))
    _assert_close(out.numpy(), ref)
    # zero padding: an extra zero plane on every side changes nothing
    padded = k4.interior_stencil_plain(
        torch.nn.functional.pad(torch.from_numpy(xs), (1, 1) * 3), taps
    )[:, 1:-1, 1:-1, 1:-1]
    _assert_close(padded.numpy(), ref)


@pytest.mark.parametrize("case", ["plain", "fixes", "xpad", "nx1", "ny1_nz1",
                                  "spacing_gravity_ztraction"])
def test_split_operator_matches_reference(case, forced, monkeypatch):
    dims, kw = CASES[case]
    jm, _, tm, _ = build_pair(dims, kw)
    assert tops.slender_route(tm, torch.float32)
    calls = []
    for mod, name in ((k4, "interior_stencil"), (g2, "keff_boundary"),
                      (k12, "apply_keff_fused")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    x = _x(jm.vector_shape, seed=11)
    ref = np.asarray(jm.apply_keff(jnp.asarray(x), SS, MF))
    out = tm.apply_keff(torch.from_numpy(x), SS, MF).numpy()
    assert calls == ["interior_stencil", "keff_boundary"]
    # the BASELINE operator tolerance, per DOF, and the kernels' 1e-5
    assert np.all(np.abs(out - ref) <= np.maximum(1e-4, 3e-4 * np.abs(ref)))
    _assert_close(out, ref)
    # constrained rows are the input itself, bit for bit
    bc = np.asarray(jm.bc_mask)
    np.testing.assert_array_equal(out[bc], x[bc])


def test_ghost_table_completes_the_interior_stencil():
    dims, kw = CASES["spacing_gravity_ztraction"]
    _, _, tm, _ = build_pair(dims, kw)
    ghost = tops.ghost_stencil_table(tm.spacing, tm.lam0, tm.mu0)
    interior = tops.interior_taps(tm).reshape(27, 3, 3)
    cls = tops.class_stencil_table(tm.spacing, tm.lam0, tm.mu0)
    assert ghost.shape == (27, 27, 3, 3) and ghost.dtype == np.float32
    interior_class = 13  # (1, 1, 1)
    assert not ghost[interior_class].any()
    np.testing.assert_allclose(interior[None] - ghost, cls, rtol=0,
                               atol=1e-6 * np.abs(cls).max())
    # every boundary class misses some taps
    assert all(ghost[c].any() for c in range(27) if c != interior_class)


def emulate_keff_boundary(model, interior, x, ss, mf):
    """numpy emulation of the G2 kernel: per boundary-class node the
    class's ghost taps on the 27 sanitized neighbours (zero outside the
    grid), then scale, mass from m8 and the class weights, identity rows."""
    ghost = tops.ghost_stencil_table(model.spacing, model.lam0, model.mu0)
    bc = model.bc_mask.numpy()
    _, X, Y, Z = x.shape
    xs = np.where(bc, 0.0, x).astype(np.float64)
    xp = np.pad(xs, ((0, 0), (1, 1), (1, 1), (1, 1)))
    cx = tops.axis_classes(X, model.nx)
    cy = tops.axis_classes(Y, model.ny)
    cz = tops.axis_classes(Z, model.nz)
    cls = (cx[:, None, None] * 3 + cy[None, :, None]) * 3 + cz[None, None, :]
    corr = np.zeros((3, X, Y, Z))
    for d in np.ndindex(3, 3, 3):
        win = xp[:, d[0]:d[0] + X, d[1]:d[1] + Y, d[2]:d[2] + Z]
        blk = ghost[cls, (d[0] * 3 + d[1]) * 3 + d[2]].astype(np.float64)
        corr += np.einsum("xyzbc,cxyz->bxyz", blk, win)

    def weight(c):
        return np.where(c == 1, 1.0, 0.5)

    mass = (model.m8 * weight(cx)[:, None, None] * weight(cy)[None, :, None]
            * weight(cz)[None, None, :])
    return np.where(bc, x, float(ss) * (interior - corr) + float(mf) * mass * xs)


@pytest.mark.parametrize("case", ["fixes", "xpad", "nx1", "ny1_nz1"])
def test_boundary_emulation_matches_plain(case):
    dims, kw = CASES[case]
    _, _, tm, _ = build_pair(dims, kw)
    x = _x(tm.vector_shape, seed=5)
    xs = torch.from_numpy(x).masked_fill(tm.bc_mask, 0.0)
    interior = k4.interior_stencil_plain(xs, tops.interior_taps(tm))
    ref = g2.keff_boundary_plain(tm, interior, torch.from_numpy(x), SS, MF)
    _assert_close(
        emulate_keff_boundary(tm, interior.numpy().astype(np.float64), x, SS, MF),
        ref.numpy(),
    )
    # the plain G2 after the plain K4 is the plain complete operator
    np.testing.assert_array_equal(
        ref.numpy(),
        tops.apply_keff_structured_plain(tm, torch.from_numpy(x), SS, MF).numpy(),
    )


ROUTES = {
    (1024, 48, 48): True,  # the soil column
    (256, 256, 256): False,  # the 255^3 cantilever
    (25, 9, 9): False,  # cantilever_box
    (67, 67, 67): False,
    (2000, 40, 40): True,
    (700, 30, 30): False,  # 630,000 nodes
}


@pytest.mark.parametrize("grid", sorted(ROUTES), ids=lambda g: "x".join(map(str, g)))
def test_route_by_shape(grid):
    model = types.SimpleNamespace(grid_shape=grid)
    assert tops.slender_route(model, torch.float32) is ROUTES[grid]
    assert tops.slender_route(model, torch.float64) is False


def test_what_declines_on_the_route(forced, monkeypatch):
    dims, kw = CASES["fixes"]
    _, _, tm, _ = build_pair(dims, kw)
    pc = tm.build_preconditioner(SS, MF)
    r = torch.from_numpy(_x(tm.vector_shape, seed=3)).masked_fill(tm.bc_mask, 0.0)
    assert tm.apply_pc_keff_dots(pc, r, SS, MF, torch.float64) is None
    monkeypatch.setenv("CIVIWAVE_MEGA_PCG", "1")
    assert tm.build_fused_pcg_iteration(
        pc, SS, MF, torch.float64, torch.float32) is None
    assert not tops.pc_keff_kernel_eligible(tm, pc, torch.float32)
    # (u, w) composes the preconditioner and the split operator, never K2
    monkeypatch.setattr(k12, "apply_pc_keff_fused", None)
    u, w = tm.apply_pc_keff(pc, r, SS, MF)
    u_ref = tm.apply_preconditioner(pc, r)
    torch.testing.assert_close(u, u_ref, rtol=0, atol=0)
    torch.testing.assert_close(w, tm.apply_keff(u_ref, SS, MF), rtol=0, atol=0)


def column_node(cells, variant="auto"):
    """The soil column scenario of the issue's YAML (the basin's material,
    damping, time step, solver and pulse; an absorbing base fed by a shear
    traction) as a config node both packages' loaders read."""
    nx, ny, nz = cells
    return {
        "mesh": {"path": f"synthetic://box/{nx},{ny},{nz},hex,0.25"},
        "materials": [{"name": "soil", "E": 2.0e8, "nu": 0.3, "rho": 1800.0}],
        "assignments": [{"group": "SOLID", "material": "soil"}],
        "damping": {"xi": 0.01, "w1": 5.0, "w2": 50.0},
        "time": {"dt": 0.002, "adaptive": False},
        "solver": {"type": "pcg", "preconditioner": "block_jacobi",
                   "tol_runtime": 2.0e-4, "tol_pause": 1.0e-5,
                   "max_iters": 120, "variant": variant},
        "precision": {"vectors": "fp32", "reductions": "fp64"},
        "curves": {"pulse": [[0.0, 0.0], [0.02, 1.0], [0.04, -0.6],
                             [0.06, 0.15], [0.08, 0.0]]},
        "loads": {"gravity": [0.0, 0.0, 0.0], "tractions": [
            {"group": "SIDE_X0", "value": [0.0, 5.0e4, 0.0],
             "scale_curve": "pulse"}]},
        "dirichlet": {"fixes": []},
        "boundaries": {"absorbing": ["SIDE_X0"]},
        "output": {"vtu_stride": 10, "probes": [0]},
    }


def test_soil_column_config_is_the_scenario():
    from civiwave_tpu_torch.config.loader import parse_config_node

    assert soil_column_config() == parse_config_node(column_node((1023, 47, 47)))
    assert soil_column_config(cells=(40, 5, 5)) == parse_config_node(
        column_node((40, 5, 5)))
    # the full column: 1024 x 48 x 48 nodes, 7,077,888 DOF, slender
    model = types.SimpleNamespace(grid_shape=(1024, 48, 48))
    assert 3 * int(np.prod(model.grid_shape)) == 7_077_888
    assert tops.slender_route(model, torch.float32)


@pytest.mark.parametrize("variant", ["classic", "fused"])
def test_soil_column_trajectory_matches_reference(variant, forced, tmp_path):
    from civiwave_tpu_torch.config.loader import parse_config_node

    node = column_node((40, 5, 5), variant)
    sim = build_simulation(parse_config_node(node), device="cpu")
    assert tops.slender_route(sim.model, torch.float32)
    assert sim.model.absorb_faces == ("x0",)
    tel = sim.run(10)
    # the reference's runner reads a scenario file (JSON is YAML)
    path = tmp_path / "column.yaml"
    path.write_text(json.dumps(node))
    jsim = jbuild_simulation(str(path))
    jtel = jsim.run(10)
    iters = [t.pcg_iterations for t in tel]
    jiters = [t.pcg_iterations for t in jtel]
    assert all(abs(a - b) <= 1 for a, b in zip(iters, jiters)), (iters, jiters)
    assert all(t.pcg_converged for t in tel) and sum(iters) > 0
    for name, tol in (("displacement", U_TOL), ("acceleration", A_TOL)):
        ref = np.asarray(getattr(jsim.stepper.state, name))
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(
            getattr(sim.stepper.state, name).numpy(), ref, rtol=0.0,
            atol=tol * np.abs(ref).max(), err_msg=name,
        )
