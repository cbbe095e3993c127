"""Geometric multigrid of the port (``ops/multigrid.py``) against the JAX
reference (``civiwave_tpu.ops.multigrid``).

* transfers and the host restriction twin against the reference's, at odd
  and even extents;
* the hierarchy of the reference's fixture (10x6x6 cells, +X padded to a
  multiple of 4): level shapes, ``bc_mask``, ``mass_grid`` and spacing
  equal, omegas at rtol 1e-3;
* the scaled block inverse at coarse-level magnitudes, and the per-node
  block-Jacobi apply;
* the V-cycle on the reference's own hierarchy, carried across through
  ``convert``, against ``apply_mg_preconditioner`` at 1e-5 * max|ref|, and
  its symmetry and positive definiteness;
* multigrid PCG iterations within +-1 of the reference's and under half
  of block-Jacobi's, in the pure-stiffness regime;
* the fallbacks (a grid too small to coarsen, a shard);
* the coarse levels' mass: the kernels synthesize ``m8`` times 0.5 per
  boundary axis, a coarse level stores P^T m_f (0.875 on the high face of
  an even node count).  The numpy emulation of K1 (synthesized mass) plus
  the level's correction equals the plain operator (stored mass) on every
  coarse level of a 15^3-cell grid.

Newmark stepping under multigrid is ``test_torch_multigrid_stepping.py``.
Inputs come from seeded numpy and reach both packages as f32 arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from civiwave_tpu.ops import multigrid as jmg
from civiwave_tpu.ops import structured as jops
from civiwave_tpu.solver.pcg import solve_pcg as jsolve_pcg
from civiwave_tpu_torch import convert
from civiwave_tpu_torch.ops import multigrid as tmg
from civiwave_tpu_torch.ops import structured as tops
from civiwave_tpu_torch.solver.pcg import solve_pcg

from test_torch_structured import build_pair, emulate_keff

torch.set_num_threads(2)

OP_TOL = 1e-5  # of max|ref|
FIXTURE = ((10, 6, 6), dict(traction=(0.0, 0.0, -1.0e6), pad_x_multiple=4))
SCALARS = {
    "newmark": (np.float32(1.0 + 2000.0 * 3.6363636e-4),
                np.float32(4.0e6 + 2000.0 * 0.36363636)),
    "mass": (np.float32(1.0), np.float32(1.0e3)),
    "static": (np.float32(1.0), np.float32(0.0)),
}


def _arrays(jm):
    """A JAX structured model's (arrays, meta) for ``convert``."""
    arrays = {n: np.asarray(getattr(jm, n)) for n in convert.STRUCTURED_ARRAYS}
    meta = {n: getattr(jm, n) for n in convert.STRUCTURED_META}
    meta.update(pad_rows=jm.pad_rows, homogeneous=jm.homogeneous)
    return arrays, meta


def carry(jm):
    """The JAX multigrid model, hierarchy and omegas included, through
    ``convert``."""
    arrays, meta = _arrays(jm)
    meta.update(preconditioner=jm.preconditioner, mg_omegas=jm.mg_omegas)
    return convert.structured_model_from_arrays(
        arrays, meta, "cpu", levels=[_arrays(lvl) for lvl in jm.mg_levels]
    )


@pytest.fixture(scope="module")
def hierarchy():
    """(JAX model with its hierarchy, JAX force, the port's own attach,
    the JAX hierarchy carried across)."""
    jm, jf, tm, _ = build_pair(*FIXTURE)
    ja = jmg.attach_multigrid(jm)
    return ja, jf, tmg.attach_multigrid(tm), carry(ja)


def _free_noise(model, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    v = scale * rng.standard_normal(model.vector_shape)
    return np.where(model.bc_mask.numpy(), 0.0, v).astype(np.float32)


@pytest.mark.parametrize("shape", [(9, 8, 7), (8, 8, 8), (5, 11, 4)])
def test_transfers_match_reference(shape):
    rng = np.random.default_rng(sum(shape))
    fine = rng.standard_normal((3, *shape)).astype(np.float32)
    coarse_shape = tuple((d + 1) // 2 for d in shape)
    coarse = rng.standard_normal((3, *coarse_shape)).astype(np.float32)
    np.testing.assert_allclose(
        tmg.restrict(torch.from_numpy(fine)).numpy(),
        np.asarray(jmg.restrict(jnp.asarray(fine))), rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        tmg.prolong(torch.from_numpy(coarse), shape).numpy(),
        np.asarray(jmg.prolong(jnp.asarray(coarse), shape)), rtol=1e-6,
        atol=1e-6,
    )
    # the host twin equals the reference's twin bit for bit and the
    # device restriction to f64 rounding
    x = rng.standard_normal((1, *shape))
    ours, ref = x, x
    for ax in range(3):
        ours = tmg._restrict_axis_np(ours, 1 + ax)
        ref = jmg._restrict_axis_np(ref, 1 + ax)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_allclose(
        tmg.restrict(torch.from_numpy(x)).numpy(), ours, rtol=1e-12, atol=1e-12
    )
    # restriction is the exact transpose of prolongation
    lhs = float((tmg.prolong(torch.from_numpy(coarse).double(), shape)
                 * torch.from_numpy(fine).double()).sum())
    rhs = float((torch.from_numpy(coarse).double()
                 * tmg.restrict(torch.from_numpy(fine).double())).sum())
    assert lhs == pytest.approx(rhs, rel=1e-12)


def test_hierarchy_matches_reference(hierarchy):
    ja, _, ta, _ = hierarchy
    assert ta.preconditioner == "multigrid" and ta.multigrid
    assert len(ta.mg_levels) == len(ja.mg_levels) >= 1
    for jl, tl in zip(ja.mg_levels, ta.mg_levels):
        assert tl.grid_shape == jl.grid_shape
        assert tl.spacing == tuple(float(h) for h in jl.spacing)
        np.testing.assert_array_equal(tl.bc_mask.numpy(), np.asarray(jl.bc_mask))
        np.testing.assert_array_equal(tl.mass_grid.numpy(),
                                      np.asarray(jl.mass_grid))
        assert tl.m8 == float(np.asarray(jl.mass_grid)[1, 1, 1])
    np.testing.assert_allclose(ta.mg_omegas, ja.mg_omegas, rtol=1e-3)
    assert all(0.0 < w < 1.0 for w in ta.mg_omegas)
    # injected constraints: the coarse x0 plane stays fully fixed
    assert bool(ta.mg_levels[0].bc_mask[:, 0].all())


def test_scaled_block_inverse_and_per_node_apply():
    """Coarse-level magnitudes (diagonal ~3e14) stay finite through the
    scaled inversion and match the reference's; the per-node apply of the
    unscaled inverse matches the reference's apply."""
    jm, _, tm, _ = build_pair((4, 4, 4), dict(spacing=(32.0, 32.0, 32.0)))
    ss, mf = np.float32(1.0), np.float32(4.0e6)
    ours = tmg._block_inverse_scaled(tm, ss, mf).numpy()
    ref = np.asarray(jmg._block_inverse_scaled(jm, ss, mf))
    assert np.isfinite(ours).all() and (ours[:3] > 0).all()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())

    jm, _, tm, _ = build_pair(*FIXTURE)
    ss, mf = SCALARS["newmark"]
    inv_t = tops.build_block_jacobi_inverse_structured(tm, ss, mf)
    inv_j = jops.build_block_jacobi_inverse_structured(jm, ss, mf)
    r = _free_noise(tm, 5)
    got = tops.apply_preconditioner_structured(tm, inv_t, torch.from_numpy(r))
    want = np.asarray(jops.apply_preconditioner_structured(jm, inv_j, jnp.asarray(r)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=OP_TOL * np.abs(want).max())
    assert not got.numpy()[tm.bc_mask.numpy()].any()


@pytest.mark.parametrize("scalars", sorted(SCALARS))
def test_vcycle_matches_reference(hierarchy, scalars):
    ja, _, ta, carried = hierarchy
    ss, mf = SCALARS[scalars]
    r = _free_noise(ta, 11, 1e3)
    want = np.asarray(ja.apply_preconditioner(
        ja.build_preconditioner(ss, mf), jnp.asarray(r)))
    for model in (carried, ta):  # the reference's hierarchy, then our own
        got = model.apply_preconditioner(
            model.build_preconditioner(ss, mf), torch.from_numpy(r)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=OP_TOL * np.abs(want).max())


def test_vcycle_symmetric_positive_definite(hierarchy):
    _, _, ta, _ = hierarchy
    ss, mf = SCALARS["mass"]
    pc = ta.build_preconditioner(ss, mf)

    def apply(v):
        return ta.apply_preconditioner(pc, torch.from_numpy(v).double()).double()

    x, y = _free_noise(ta, 1), _free_noise(ta, 2)
    xt, yt = torch.from_numpy(x).double(), torch.from_numpy(y).double()
    x_my, y_mx = float((xt * apply(y)).sum()), float((yt * apply(x)).sum())
    assert x_my == pytest.approx(y_mx, rel=1e-10)
    assert float((xt * apply(x)).sum()) > 0.0
    assert float((yt * apply(y)).sum()) > 0.0
    assert not apply(x).numpy()[ta.bc_mask.numpy()].any()


def test_pcg_iterations_match_reference(hierarchy):
    """Pure stiffness (the hard regime for block-Jacobi) to 1e-8: the
    port's multigrid iterations within +-1 of the reference's, under half
    of block-Jacobi's, the same solution."""
    ja, jf, ta, _ = hierarchy
    ss, mf = SCALARS["static"]
    rhs = np.where(np.asarray(ja.bc_mask), np.asarray(ja.bc_value),
                   np.asarray(jf)).astype(np.float32)
    x0 = np.zeros(ja.vector_shape, np.float32)
    xj, telj = jax.jit(lambda m, r, x: jsolve_pcg(
        m, r, ss, mf, 1.0e-8, 1500, x, warm_start=False))(
            ja, jnp.asarray(rhs), jnp.asarray(x0))
    args = (torch.from_numpy(rhs), ss, mf, 1.0e-8, 1500, torch.from_numpy(x0))
    xt, telt = solve_pcg(ta, *args, warm_start=False, variant="auto")
    bj = dataclasses.replace(ta, preconditioner="block_jacobi", mg_levels=(),
                             mg_omegas=())
    xb, telb = solve_pcg(bj, *args, warm_start=False, variant="classic")
    assert telt.converged and bool(telj.converged) and telb.converged
    assert abs(telt.iterations - int(telj.iterations)) <= 1
    assert telt.iterations < telb.iterations / 2, (telt.iterations, telb.iterations)
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-5 * np.abs(xj).max())
    np.testing.assert_allclose(xb.numpy(), xj, rtol=0, atol=1e-5 * np.abs(xj).max())


def test_fallbacks(capsys):
    """Too small to coarsen: unchanged.  A shard: block-Jacobi with the
    reference's note, from attach_multigrid and from shard_structured."""
    _, _, tiny, _ = build_pair((2, 2, 2), {})
    assert tmg.attach_multigrid(tiny) is tiny
    _, _, tm, tf = build_pair(*FIXTURE)
    shard = dataclasses.replace(tm, shard_group=object())
    out = tmg.attach_multigrid(shard)
    assert out.preconditioner == "block_jacobi" and not out.mg_levels
    assert "falling back to block_jacobi" in capsys.readouterr().err

    from civiwave_tpu_torch.parallel.sharding import (
        close_shard_group,
        make_shard_group,
        shard_structured,
    )

    mg = tmg.attach_multigrid(tm)
    group = make_shard_group(1, "cpu")
    try:
        local, _, _ = shard_structured(mg, mg.zero_state(), tf, group)
    finally:
        close_shard_group()
    assert local.preconditioner == "block_jacobi" and not local.mg_levels
    assert "coarse levels are not distributed" in capsys.readouterr().err


def test_coarse_level_mass_correction_restores_the_operator():
    """15^3 cells (16 nodes per axis, even): every coarse level stores a
    mass the kernels do not synthesize; K1's arithmetic (the numpy
    emulation, synthesized mass) plus the level's correction equals the
    plain operator, which reads the stored mass."""
    _, _, tm, _ = build_pair((15, 15, 15), {})
    mg = tmg.attach_multigrid(tm)
    assert tm.mass_correction is None
    assert [lvl.grid_shape for lvl in mg.mg_levels] == [(8, 8, 8), (4, 4, 4)]
    ss, mf = SCALARS["newmark"]
    for i, lvl in enumerate(mg.mg_levels):
        corr = lvl.mass_correction
        assert corr is not None, i
        mass = lvl.mass_grid.numpy()
        if i == 0:  # 16 fine nodes: the high face carries 0.875, not 0.5
            assert mass[-1, 1, 1] / mass[1, 1, 1] == 0.875
        synth = tops.synthesized_mass(lvl).numpy()
        assert np.array_equal(synth.reshape(-1)[corr.index.numpy()] + corr.delta.numpy(),
                              mass.reshape(-1)[corr.index.numpy()])
        x = np.random.default_rng(i).standard_normal(lvl.vector_shape)
        x = x.astype(np.float32)
        plain = tops.apply_keff_structured_plain(lvl, torch.from_numpy(x), ss, mf)
        kernel = torch.from_numpy(emulate_keff(lvl, x, ss, mf).astype(np.float32))
        scale = float(plain.abs().max())
        assert float((kernel - plain).abs().max()) > OP_TOL * scale  # the trap
        fixed = tops.correct_synthesized_mass(lvl, kernel, torch.from_numpy(x), mf)
        np.testing.assert_allclose(fixed.numpy(), plain.numpy(), rtol=0,
                                   atol=OP_TOL * scale)
        bc = lvl.bc_mask.numpy()
        np.testing.assert_array_equal(fixed.numpy()[bc], x[bc])
