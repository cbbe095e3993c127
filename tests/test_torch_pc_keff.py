"""Fused preconditioner + operator (+ dots) of the port against the JAX
reference's Pallas kernel ``apply_pc_keff_fused_pallas(with_dots=True)``
in interpret mode (even x-plane count, as that kernel requires) and the
reference's composition, plus a numpy emulation of the K2 CUDA kernel
(u from the K3 arithmetic, w from the K1 arithmetic, row partials of the
three dots).  Tolerances: u at 1e-6 * max|ref|, w at 1e-5 * max|ref|
(the operator tolerance), dots at rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from civiwave_tpu.ops import structured as jops
from civiwave_tpu.ops.pallas.structured_stencil import apply_pc_keff_fused_pallas
from civiwave_tpu.solver.pcg import fused_dots as jfused_dots
from civiwave_tpu_torch.mesh import structured as tstructured
from civiwave_tpu_torch.ops import multigrid as tmg
from civiwave_tpu_torch.ops import structured as tops
from civiwave_tpu_torch.ops.cuda import structured_stencil as k12
from civiwave_tpu_torch.parallel.sharding import (
    close_shard_group,
    make_shard_group,
    shard_structured,
)
from civiwave_tpu_torch.physics import materials as tmaterials
from civiwave_tpu_torch.solver.pcg import resolve_variant
from civiwave_tpu_torch.utils.synthetic import cantilever_config

from test_torch_block_jacobi import emulate_block_jacobi
from test_torch_structured import CASES, build_pair, emulate_keff

torch.set_num_threads(2)

SS, MF = np.float32(1.3), np.float32(2.5e5)


def _close(out, ref, rel):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(
        out, ref, rtol=0.0, atol=rel * (np.abs(ref).max() + 1e-30)
    )


def emulate_pc_keff(model, table, r):
    """numpy emulation of K2: u = M^-1 r per node, w = K_eff u with the
    class stencil, and the (r,u), (r,r), (w,u) sums of the row partials."""
    u = emulate_block_jacobi(model, table, r)
    w = emulate_keff(model, u, SS, MF)
    rows = [(r * u).sum(axis=(0, 3)), (r.astype(np.float64) ** 2).sum(axis=(0, 3)),
            (w * u).sum(axis=(0, 3))]
    gamma, rr, delta = (float(p.sum()) for p in rows)
    return u, w, (gamma, delta, rr)


def test_matches_pallas_interpret_kernel_with_dots():
    jm, _, tm, _ = build_pair((5, 3, 2), dict(fixed_axis_planes=("x0", "y1")))
    assert jm.grid_shape[0] % 2 == 0  # the Pallas kernel is blocked by 2
    pc_j = jm.build_preconditioner(SS, MF)
    pc_t = tm.build_preconditioner(SS, MF)
    r = np.random.default_rng(13).standard_normal(jm.vector_shape).astype(np.float32)
    tables = jops._stencil_tables(jm.spacing, jm.lam0, jm.mu0)
    u_j, w_j, pa, pb = apply_pc_keff_fused_pallas(
        jm, pc_j.table, jnp.asarray(r), SS, MF, tables, with_dots=True,
        interpret=True,
    )
    dots_j = (
        float(jnp.sum(pa[:, 0].astype(jnp.float64))),
        float(jnp.sum(pb[:, 0].astype(jnp.float64))),
        float(jnp.sum(pa[:, 1].astype(jnp.float64))),
    )
    u, w, dots = k12.apply_pc_keff_fused(
        tm, pc_t.table, torch.from_numpy(r), SS, MF, with_dots=True
    )
    _close(u.numpy(), u_j, 1e-6)
    _close(w.numpy(), w_j, 1e-5)
    for ours, ref in zip(dots, dots_j):
        assert float(ours) == pytest.approx(ref, rel=1e-5)
        assert ours.dtype == torch.float64
    eu, ew, edots = emulate_pc_keff(tm, pc_t.table.numpy(), r)
    _close(eu, u_j, 1e-6)
    _close(ew, w_j, 1e-5)
    for ours, ref in zip(edots, dots_j):
        assert ours == pytest.approx(ref, rel=1e-5)


@pytest.mark.parametrize("case", ["xpad", "nx1"])
def test_matches_reference_composition(case):
    dims, kw = CASES[case]
    jm, _, tm, _ = build_pair(dims, kw)
    pc_j = jm.build_preconditioner(SS, MF)
    pc_t = tm.build_preconditioner(SS, MF)
    r = np.random.default_rng(17).standard_normal(jm.vector_shape).astype(np.float32)
    u_j, w_j = jm.apply_pc_keff(pc_j, jnp.asarray(r), SS, MF)
    g, d, rr = jfused_dots(
        [(jnp.asarray(r), u_j), (w_j, u_j), (jnp.asarray(r), jnp.asarray(r))]
    )
    u, w = tm.apply_pc_keff(pc_t, torch.from_numpy(r), SS, MF)
    _close(u.numpy(), np.asarray(u_j), 1e-6)
    _close(w.numpy(), np.asarray(w_j), 1e-5)
    u2, w2, dots = tm.apply_pc_keff_dots(
        pc_t, torch.from_numpy(r), SS, MF, torch.float64
    )
    assert torch.equal(u2, u) and torch.equal(w2, w)
    for ours, ref in zip(dots, (g, d, rr)):
        assert float(ours) == pytest.approx(float(ref), rel=1e-5)
    # constrained outputs of both u and w are +0.0
    bc = tm.bc_mask.numpy()
    for v in (u.numpy(), w.numpy()):
        assert not v[bc].any() and not np.signbit(v[bc]).any()


# --- the route table -----------------------------------------------------------

F32, F64 = torch.float32, torch.float64
# route: (K2 predicate, apply_pc_keff_dots declines, a K6 bundle under
# CIVIWAVE_MEGA_PCG=1, what 'auto' resolves to on the CPU).  The last three
# columns are the answers of the code before the route's terms were written
# once; its predicate read the device as well (False on every CPU route),
# which now only 'auto' reads.
ROUTE_TABLE = {
    "homogeneous_f32": (True, False, True, "classic"),
    "fp64_vectors": (False, True, False, "classic"),
    "heterogeneous": (False, True, False, "classic"),
    "slender": (False, True, False, "classic"),
    "one_rank_shard": (False, True, False, "fused"),
    "multigrid": (False, True, False, "classic"),
    "absorbing_faces": (True, True, False, "classic"),
}


def _route_model(route, monkeypatch):
    """(model, vector dtype) of one structured route, built on the CPU."""
    mat = cantilever_config().materials[0]
    props = tmaterials.make_properties(mat)

    def build(dims=(6, 5, 4), **kw):
        return tstructured.build_structured_model(
            *dims, props, mat.density, device="cpu",
            traction=(0.0, 0.0, -1.0e6), **kw)

    if route == "heterogeneous":
        rng = np.random.default_rng(7)
        grids = {name: base * (1.0 + rng.uniform(0.0, 1.0, (6, 5, 4)))
                 for name, base in (("lam_grid", props.lame.lam),
                                    ("mu_grid", props.lame.mu))}
        return build(**grids)[0], F32
    if route == "multigrid":
        return tmg.attach_multigrid(build((10, 6, 6), pad_x_multiple=4)[0]), F32
    if route == "absorbing_faces":
        return build(absorb_planes=("x1", "y0"))[0], F32
    model, force = build()
    if route == "slender":
        monkeypatch.setattr(tops, "_FLAT_INTERIOR_NODE_THRESHOLD", 0)
    if route == "one_rank_shard":
        group = make_shard_group(1, "cpu")
        try:
            model = shard_structured(model, model.zero_state(), force, group)[0]
        finally:
            close_shard_group()
    return model, F64 if route == "fp64_vectors" else F32


@pytest.mark.parametrize("route", sorted(ROUTE_TABLE))
def test_route_table(route, monkeypatch):
    """Every structured route buildable on the CPU: the one K2 predicate,
    whether the K2-with-dots call declines, whether the whole-iteration
    bundle is built under its switch, and the 'auto' variant."""
    model, dtype = _route_model(route, monkeypatch)
    assert model.multigrid == (route == "multigrid")
    assert (model.shard_group is not None) == (route == "one_rank_shard")
    assert model.homogeneous == (route != "heterogeneous")
    assert bool(model.absorb_faces) == (route == "absorbing_faces")
    assert tops.slender_route(model, dtype) == (route == "slender")
    pc = model.build_preconditioner(SS, MF)
    r = torch.ones(model.vector_shape, dtype=dtype).masked_fill(model.bc_mask, 0.0)
    monkeypatch.setenv("CIVIWAVE_MEGA_PCG", "1")
    got = (
        tops.pc_keff_kernel_eligible(model, pc, dtype),
        model.apply_pc_keff_dots(pc, r, SS, MF, F64) is None,
        model.build_fused_pcg_iteration(pc, SS, MF, F64, dtype) is not None,
        resolve_variant(model, "auto", pc, dtype),
    )
    assert got == ROUTE_TABLE[route]
