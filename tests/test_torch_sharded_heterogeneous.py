"""Heterogeneous structured grids (per-cell λ/μ) on a shard, against the
JAX package on the CPU.

The reference shards such a grid under GSPMD, λ/μ cut along X (and Y)
with the vectors (civiwave_tpu/parallel/sharding.py:211-232), and pins it
on 8 slabs of cells 15x6x6 and 4x2 tiles of cells 7x4x5 with a dead +Y row
(tests/test_sharding.py:468, :852).  The port runs G3 on each shard over
its plane range, with the x ghosts of K5's exchange and the ghost cells
exchanged once at shard time; on the CPU G3's plain shard version.

* In one process, without a group: every tile of ``local_tiles`` (its
  mask ghosts and ghost cells cut from the global grids) through
  ``local_keff`` with the x ghosts cut from x, one launch or the overlap
  split's three (``CIVIWAVE_HALO_OVERLAP`` 0 and 1), gathered: against
  the reference's operator on the GSPMD-sharded model (the conftest's 8
  virtual CPU devices) and unsharded, 1e-5 of max|ref| in f32 and 1e-12
  in f64, and bit for bit against the port's unsharded plain version.
* Each shard's per-node block-Jacobi inverse against the reference's
  unsharded ``build_block_jacobi_inverse_structured`` cut to the block
  (1e-6 of max, per packed component).
* Spawned gloo ranks at 2, 4 and 2x2 (``tests/torch_sharded_support.py
  --hetero``): the exchanged ghost cells equal the cut ones; 4 Newmark
  frames ('auto' = fused on a shard) against the reference's sharded
  ``newmark_step`` on a device mesh of the same shape (iterations +-1, u
  2.5e-4 and a 3e-3 of max|ref|), one more at the reference's own setting
  (tol 1e-7: u 1e-5 of max); the collective budget: at shard time the
  mask's 2 or 4 exchanges and the ghost cells' 1 or 2, then one f64 (3,)
  all-reduce per fused iteration and 2 or 4 ghost exchanges per matvec.
* A one-rank gloo group through ``shard_structured``: the normal dispatch,
  fused frames and a static solve against the unsharded model.
"""

import json
import os
import subprocess
import sys
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from civiwave_tpu.mesh import structured as jstructured
from civiwave_tpu.ops import structured as jops
from civiwave_tpu.parallel import sharding as jsharding
from civiwave_tpu.physics import materials as jmaterials
from civiwave_tpu.solver.stepper import newmark_step
from civiwave_tpu_torch.mesh import structured as tstructured
from civiwave_tpu_torch.ops import structured as tops
from civiwave_tpu_torch.ops import structured_sharded as tss
from civiwave_tpu_torch.ops.cuda import corner_gather as g3
from civiwave_tpu_torch.parallel import collectives
from civiwave_tpu_torch.parallel import sharding as tsharding
from civiwave_tpu_torch.physics import materials as tmaterials
from civiwave_tpu_torch.solver.static import solve_static
from civiwave_tpu_torch.utils.synthetic import cantilever_config
from test_torch_sharded_path import _run_ranks
from torch_sharded_support import FRAMES, hetero_cells

torch.set_num_threads(2)

CPU = torch.device("cpu")
SS, MF = np.float32(1.01), np.float32(3.7)
TOL = {np.float32: 1e-5, np.float64: 1e-12}  # of max|ref|
PC_TOL = 1e-6
U_TOL, A_TOL = 2.5e-4, 3e-3
TIGHT_U_TOL = 1e-5  # the reference's sharded-against-single bound at tol 1e-7
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUPPORT = os.path.join(REPO, "tests", "torch_sharded_support.py")
DTYPES = pytest.mark.parametrize("dtype", [np.float32, np.float64],
                                 ids=["f32", "f64"])

# name -> (cells, (npx, npy), 2-D): the reference's own cuts, and 4 slabs
# of 4 planes (the overlap split's three ranges)
GRIDS = {
    "1d_15x6x6_over_4": ((15, 6, 6), (4, 1), False),
    "1d_15x6x6_over_8": ((15, 6, 6), (8, 1), False),
    "2d_7x4x5_on_2x2": ((7, 4, 5), (2, 2), True),  # a dead +Y row
    "2d_7x4x5_on_4x2": ((7, 4, 5), (4, 2), True),
}

# the spawned groups: name -> (cells, npx, npy, 2-D)
GROUPS = {
    "1d_2": ((7, 3, 3), 2, 1, False),
    "1d_4": ((15, 4, 4), 4, 1, False),  # Xl = 4: the overlap split
    "2d_2x2": ((9, 4, 5), 2, 2, True),  # a dead +Y row
}


def _kw(shape, two_d):
    return dict(traction=(0.0, 0.0, -1.0e6), pad_x_multiple=shape[0],
                pad_y_multiple=shape[1] if two_d else 1)


@lru_cache(maxsize=None)
def _pair(cells, shape, two_d):
    """(JAX model, JAX force, port model, port force) of the padded
    heterogeneous cantilever."""
    mat = cantilever_config().materials[0]
    lam, mu = hetero_cells(cells)
    kw = dict(_kw(shape, two_d), lam_grid=lam, mu_grid=mu)
    jm, jf = jstructured.build_structured_model(
        *cells, jmaterials.make_properties(mat), mat.density, **kw)
    tm, tf = tstructured.build_structured_model(
        *cells, tmaterials.make_properties(mat), mat.density, device=CPU, **kw)
    assert not jm.homogeneous and not tm.homogeneous
    return jm, jf, tm, tf


def _x(model, dtype, seed=7):
    return np.random.default_rng(seed).standard_normal(
        model.vector_shape).astype(dtype)


def _scalars(dtype):
    return (SS, MF) if dtype == np.float32 else (np.float64(SS), np.float64(MF))


def _mesh(npx, npy, two_d):
    if two_d:
        return jsharding.make_device_mesh_2d(npx, npy), {"axis_name_y": "shard_y"}
    return jsharding.make_device_mesh(npx), {}


@lru_cache(maxsize=None)
def _jax_outputs(name, dtype):
    """The reference's operator on the GSPMD-sharded model and unsharded."""
    cells, (npx, npy), two_d = GRIDS[name]
    jm, jf, _, _ = _pair(cells, (npx, npy), two_d)
    ss, mf = _scalars(dtype)
    x = jnp.asarray(_x(jm, dtype))
    apply = jax.jit(lambda m, v: m.apply_keff(v, ss, mf))
    mesh, kw = _mesh(npx, npy, two_d)
    sm, _, _ = jsharding.shard_structured(jm, jm.zero_state(), jf, mesh, **kw)
    assert not sm.lam_grid.sharding.is_fully_replicated
    spec = jax.sharding.PartitionSpec(None, "shard", "shard_y" if two_d else None)
    xs = jax.device_put(x, jax.sharding.NamedSharding(mesh, spec))
    return np.asarray(apply(jm, x)), np.asarray(apply(sm, xs))


def port_sharded(model, x, shape, two_d, ss, mf):
    """The gathered port operator over every tile of ``shape``, each with
    its x ghosts cut from ``x`` (no group)."""
    out = torch.empty_like(x)
    for local in tsharding.local_tiles(model, shape, two_d):
        x0, y0, (xl, yl) = local.x0, local.y0, local.local_extent
        xt = tsharding.cut_block(x, x0, y0, xl, yl)
        ghosts = tss.cut_ghosts(x, x0, y0, xl, yl, two_d)
        out[:, x0:x0 + xl, y0:y0 + yl] = tss.local_keff(local, xt, ghosts, ss, mf)
    return out


def _assert_close(got, ref, rel, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), f"{name}: {err:.3e}"


# --- in one process ------------------------------------------------------------


@DTYPES
@pytest.mark.parametrize("overlap", ["0", "1"])
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_shard_operator_matches_reference(name, overlap, dtype, monkeypatch):
    monkeypatch.setenv("CIVIWAVE_HALO_OVERLAP", overlap)
    cells, shape, two_d = GRIDS[name]
    _, _, tm, _ = _pair(cells, shape, two_d)
    ss, mf = _scalars(dtype)
    x = torch.as_tensor(_x(tm, dtype))
    before = (g3.apply_keff_corner_gather.launches,
              g3.apply_keff_corner_gather.launches_f64)
    got = port_sharded(tm, x, shape, two_d, ss, mf)
    # the plain version runs on the CPU: no kernel launch is counted
    assert (g3.apply_keff_corner_gather.launches,
            g3.apply_keff_corner_gather.launches_f64) == before
    unsharded, gspmd = _jax_outputs(name, dtype)
    _assert_close(got.numpy(), gspmd, TOL[dtype], "gspmd")
    _assert_close(got.numpy(), unsharded, TOL[dtype], "unsharded")
    assert torch.equal(got, tops.apply_keff_structured_plain(tm, x, ss, mf))
    bc = tm.bc_mask
    assert torch.equal(got[bc], x[bc])


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_per_node_inverse_of_every_shard(name):
    cells, shape, two_d = GRIDS[name]
    jm, _, tm, _ = _pair(cells, shape, two_d)
    ref = np.asarray(jops.build_block_jacobi_inverse_structured(jm, SS, MF))
    for local in tsharding.local_tiles(tm, shape, two_d):
        x0, y0, (xl, yl) = local.x0, local.y0, local.local_extent
        got = local.build_preconditioner(SS, MF)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == (6, xl, yl, tm.nz + 1)
        want = ref[:, x0:x0 + xl, y0:y0 + yl]
        for comp in range(6):  # each packed component against its scale
            err = np.abs(got[comp].numpy() - want[comp]).max()
            assert err <= PC_TOL * np.abs(ref[comp]).max(), (x0, y0, comp, err)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_cut_ghost_cells(name):
    """The ghost cells of every tile hold the previous slab's last cell
    plane (in 2-D from the row below the tile, the corner cell) and the
    tile below's last cell row, λ then μ, zero past the global ends."""
    cells, shape, two_d = GRIDS[name]
    _, _, tm, _ = _pair(cells, shape, two_d)
    grids = torch.stack([tm.lam_grid, tm.mu_grid])
    for local in tsharding.local_tiles(tm, shape, two_d):
        x0, y0, (xl, yl) = local.x0, local.y0, local.local_extent
        cg = local.cell_ghosts
        rows = local.lam_grid.shape[1]
        assert rows == min(yl, tm.lam_grid.shape[1] - y0)
        assert tuple(cg.x_lo.shape) == (2, rows + two_d, tm.nz)
        first = y0 - int(two_d)  # the global cell row of ghost row 0
        for r in range(rows + two_d):
            want = (grids[:, x0 - 1, first + r] if x0 and first + r >= 0
                    else torch.zeros((2, tm.nz)))
            assert torch.equal(cg.x_lo[:, r], want), (x0, y0, r)
        if two_d:
            assert tuple(cg.y_lo.shape) == (2, xl, tm.nz)
            want = (grids[:, x0:x0 + xl, y0 - 1] if y0
                    else torch.zeros((2, xl, tm.nz)))
            assert torch.equal(cg.y_lo, want)
        else:
            assert cg.y_lo is None


# --- spawned gloo ranks ---------------------------------------------------------


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """Each group's ranks, run once: (per-rank results, frames)."""
    cache = {}

    def run(name):
        if name not in cache:
            cells, npx, npy, _ = GROUPS[name]
            tmp = tmp_path_factory.mktemp(name)
            frames = tmp / "frames.npz"
            commands = [
                [sys.executable, SUPPORT, "--rank", str(rank), "--npx",
                 str(npx), "--npy", str(npy), "--cells",
                 ",".join(map(str, cells)), "--init-method",
                 f"file://{tmp / 'store'}", "--out", str(tmp / f"r{rank}.json"),
                 "--hetero", "--frames-out", str(frames)]
                for rank in range(npx * npy)
            ]
            for rc, out in _run_ranks(commands, tmp):
                assert rc == 0, out
            results = []
            for rank in range(npx * npy):
                with open(tmp / f"r{rank}.json", encoding="utf-8") as handle:
                    results.append(json.load(handle))
            cache[name] = (results, dict(np.load(frames)))
        return cache[name]

    return run


@lru_cache(maxsize=None)
def _jax_frames(name):
    """The reference's sharded newmark_step ('auto' = fused there too) on
    a mesh of the same shape: per frame (iterations, u, a) in nodal rows,
    then one frame from rest at tol 1e-7 (iterations, u)."""
    cells, npx, npy, two_d = GROUPS[name]
    jm, jf, _, _ = _pair(cells, (npx, npy), two_d)
    ray = jmaterials.compute_rayleigh(cantilever_config().damping)
    mesh, kw = _mesh(npx, npy, two_d)
    sm, state, sf = jsharding.shard_structured(jm, jm.zero_state(), jf, mesh, **kw)
    step = jax.jit(partial(newmark_step, rayleigh_alpha=ray.alpha,
                           rayleigh_beta=ray.beta))

    def nodal(v):
        return np.asarray(jm.to_nodal(jnp.asarray(v)))

    frames = []
    for _ in range(FRAMES):
        out = step(sm, state, sf, 1.0e-3, 2.0e-4, 120)
        state = out.state
        assert bool(out.pcg.converged)
        frames.append((int(out.pcg.iterations), nodal(state.displacement),
                       nodal(state.acceleration)))
    out = step(sm, sm.zero_state(), sf, 1.0e-3, 1.0e-7, 500)
    assert bool(out.pcg.converged)
    return frames, (int(out.pcg.iterations), nodal(out.state.displacement))


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_exchanged_ghost_cells_across_ranks(name, rank_runs):
    _, npx, npy, two_d = GROUPS[name]
    results, _ = rank_runs(name)
    for result in results:
        assert result["cell_ghost_mismatch"] == 0
        assert result["cell_end_nonzero"] == 0
        assert result["cell_ghost_fields"] == (["x_lo", "y_lo"] if two_d
                                               else ["x_lo"])
        assert result["ghost_err"] == 0.0 and result["bc_ghost_mismatch"] == 0
        # the gathered operator of the group is the unsharded one, bit for bit
        assert result["op_equal"]


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_frames_match_reference(name, rank_runs):
    _, got = rank_runs(name)
    assert str(got["variant"]) == "fused"
    assert got["converged"].all()
    ref, (tight_iters, tight_u) = _jax_frames(name)
    iters = got["iterations"]
    for k, (it, u, a) in enumerate(ref):
        assert abs(int(iters[k]) - it) <= 1, (iters, [f[0] for f in ref])
        for field, want, tol in (("displacement", u, U_TOL),
                                 ("acceleration", a, A_TOL)):
            np.testing.assert_allclose(
                got[field][k], want, rtol=0.0,
                atol=tol * np.abs(want).max(), err_msg=f"{field} frame {k}")
    assert bool(got["tight_converged"])
    np.testing.assert_allclose(got["tight_displacement"], tight_u, rtol=0.0,
                               atol=TIGHT_U_TOL * np.abs(tight_u).max())


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_collective_budget(name, rank_runs):
    _, _, _, two_d = GROUPS[name]
    results, got = rank_runs(name)
    # shard time: the mask's ghosts (2 or 4 exchanges), the ghost cells'
    # (1 or 2), then one matvec of the operator check (2 or 4)
    for result in results:
        assert result["shard_exchanges"] == (6 if two_d else 3)
        assert result["exchanges_per_matvec"] == (4 if two_d else 2)
    total = int(got["iterations"].sum())
    assert int(got["psum_f64_3"]) == total
    assert int(got["psum_f64_4"]) == FRAMES
    assert int(got["psum_calls"]) == total + FRAMES
    assert int(got["all_gather_calls"]) == 0
    # each frame's Rayleigh, residual and setup matvecs, then one per
    # iteration; no ghost cell is exchanged again
    assert int(got["ppermute_calls"]) == (4 if two_d else 2) * (3 * FRAMES + total)


# --- a one-rank gloo group ------------------------------------------------------


def test_one_rank_group_runs_the_heterogeneous_shard():
    """shard_structured on one-rank 1-D and 2-D gloo groups (no network):
    the ghost cells exchanged at shard time (zero: nothing is received),
    the operator through the normal dispatch equal to the unsharded one,
    3 'auto' (= fused) frames against 3 unsharded fused frames (iterations
    +-1, u 2.5e-4, a 3e-3 of max), and a static solve to 1e-6 against the
    unsharded one (u 2.5e-4 of max)."""
    from civiwave_tpu_torch.physics import materials
    from civiwave_tpu_torch.solver.stepper import NewmarkStepper

    cells = (7, 3, 3)
    _, _, tm, tf = _pair(cells, (1, 1), False)
    cfg = cantilever_config(tol_runtime=2e-4, max_iters=120, dt=1e-3,
                            adaptive=False)
    ray = materials.compute_rayleigh(cfg.damping)

    def frames(model, force, variant):
        stepper = NewmarkStepper(model, model.zero_state(), force, ray,
                                 cfg.solver, cfg.time)
        stepper.solver_variant = variant
        assert stepper.pcg_variant() == "fused"
        tel = [stepper.step(stepper.accumulated_time) for _ in range(3)]
        return tel, stepper.displacement(), stepper.acceleration()

    ref_tel, ref_u, ref_a = frames(tm, tf, "fused")
    ref_static, _ = solve_static(tm, tf, tolerance=1e-6, max_iterations=2000)
    x = torch.as_tensor(_x(tm, np.float32))
    try:
        for make, exchanges in (
            (lambda: tsharding.make_shard_group(1, "cpu"), 1),
            (lambda: tsharding.make_shard_group_2d(1, 1, "cpu"), 2),
        ):
            group = make()
            collectives.reset_counts()
            sm, _, sf = tsharding.shard_structured(tm, tm.zero_state(), tf,
                                                   group)
            # the mask's exchanges, then the ghost cells'
            assert collectives.ppermute.calls == 2 * exchanges + exchanges
            assert not sm.cell_ghosts.x_lo.any()
            assert torch.equal(sm.apply_keff(x, SS, MF), tm.apply_keff(x, SS, MF))
            tel, u, a = frames(sm, sf, "auto")
            for t, r in zip(tel, ref_tel):
                assert t.pcg_converged and abs(t.pcg_iterations - r.pcg_iterations) <= 1
            np.testing.assert_allclose(u, ref_u, rtol=0, atol=U_TOL * np.abs(ref_u).max())
            np.testing.assert_allclose(a, ref_a, rtol=0, atol=A_TOL * np.abs(ref_a).max())
            u_static, st = solve_static(sm, sf, tolerance=1e-6,
                                        max_iterations=2000)
            assert st.converged
            got = tsharding.gather_structured(u_static, group)
            np.testing.assert_allclose(
                got.numpy(), ref_static.numpy(), rtol=0,
                atol=U_TOL * float(ref_static.abs().max()))
    finally:
        tsharding.close_shard_group()
