"""Ghysels-Vanroose pipelined PCG of the port (``solve_pcg_pipelined``)
against the JAX reference's (``civiwave_tpu.solver.pcg``).

* structured models (``tests/test_torch_pcg.py``'s Newmark system) with
  ``replace_every`` 10 and 3 at 2e-4 and at 1e-7, where the residual
  replacement matters, and 0 at 2e-4 (without replacement the recurrences
  stall near 5e-5, as the reference documents), passed through
  ``solve_pcg``: iterations within +-1 of the reference's, solutions at
  1e-4 * max|ref|;
* packed models carried across through ``convert`` (the reference's bar
  fixtures, tet and hex, kappa ~1e12, tests/test_pcg.py:375-418): at 2e-4
  the same bounds; at 1e-5 the replacements rebuild Krylov information the
  f32 drift destroyed, and the drift follows the order of each f32 sum, so
  iterations are held within max(3, 20 %) of the reference's (the bound
  the reference puts on pipelined against classic, tests/test_pcg.py:
  401-403) and solutions at 1e-4 * max|ref|;
* a zero right-hand side and ``max_iterations = 0`` (converged with the
  true initial residual, no iteration);
* the pc+matvec count: one for the setup, one per loop body (the trailing
  body included) and one per replacement, on the iterations where the
  reference replaces;
* ``solver.replace_every`` reaching the solver from the stepper, from
  ``run_static`` and through ``shard_simulation``;
* a pipelined scenario stepped over a 2-rank gloo group against one rank
  (the launcher's ``--against-one-rank``), one f64 (3,) all-reduce per
  loop body.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from civiwave_tpu.mesh import pack as jpack
from civiwave_tpu.mesh import preprocess as jpreprocess
from civiwave_tpu.physics import materials as jmaterials
from civiwave_tpu.physics import newmark as jnewmark
from civiwave_tpu.solver import pcg as jpcg
from civiwave_tpu_torch.solver import pcg as tpcg
from support import bar_config, bar_mesh
from test_torch_pcg import MF, SS, _problem
from test_torch_sharded_path import JOIN_TIMEOUT, REPO, _run_ranks
from torch_general_support import to_port_packed

torch.set_num_threads(2)

SOL_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _jax_pipelined(replace_every):
    return jax.jit(functools.partial(
        jpcg.solve_pcg, variant="pipelined", replace_every=replace_every,
    ), static_argnames=("warm_start",))


def _both(model_pair, rhs, x0, ss, mf, tol, max_it, replace_every=10,
          warm_start=True):
    jm, tm = model_pair
    xj, telj = _jax_pipelined(replace_every)(
        jm, jnp.asarray(rhs), ss, mf, jnp.float64(tol), jnp.int32(max_it),
        jnp.asarray(x0), warm_start=warm_start,
    )
    xt, telt = tpcg.solve_pcg(
        tm, torch.from_numpy(rhs), ss, mf, tol, max_it, torch.from_numpy(x0),
        warm_start=warm_start, variant="pipelined", replace_every=replace_every,
    )
    return np.asarray(xj), telj, xt.numpy(), telt


def _assert_match(xj, telj, xt, telt, slack=1):
    assert telt.converged and bool(telj.converged)
    assert not telt.breakdown and not bool(telj.breakdown)
    assert abs(telt.iterations - int(telj.iterations)) <= slack
    np.testing.assert_allclose(xt, xj, rtol=0, atol=SOL_TOL * np.abs(xj).max())
    assert float(telt.residual_norm) <= float(telt.rhs_norm)
    assert float(telt.rhs_norm) == pytest.approx(float(telj.rhs_norm), rel=1e-6)


@pytest.mark.parametrize("tol, replace_every", [
    (2e-4, 10), (1e-7, 10), (1e-7, 3), (2e-4, 0),
])
def test_structured_matches_reference(tol, replace_every):
    jm, tm, rhs, x0 = _problem()
    xj, telj, xt, telt = _both((jm, tm), rhs, x0, SS, MF, tol, 300,
                               replace_every)
    _assert_match(xj, telj, xt, telt)
    assert telt.iterations > 3
    # the classic loop reaches the same solution
    xc, telc = tpcg.solve_pcg(tm, torch.from_numpy(rhs), SS, MF, tol, 300,
                              torch.from_numpy(x0), variant="classic")
    assert telc.converged
    np.testing.assert_allclose(xt, xc.numpy(), rtol=0,
                               atol=1e-3 * np.abs(xc.numpy()).max())


@functools.lru_cache(maxsize=None)
def _bar(hex_elements):
    mesh = bar_mesh(3, 1, 1, hex_elements=hex_elements)
    cfg = bar_config()
    pre = jpreprocess.run(mesh, cfg)
    mats = [jmaterials.make_properties(m) for m in cfg.materials]
    jm, _, force = jpack.build_packed_model(mesh, pre, cfg, mats)
    coeffs = jnewmark.make_coefficients(0.01)
    rhs = np.asarray(jnp.where(jm.bc_mask, jm.bc_value, force), np.float32)
    return jm, to_port_packed(jm), rhs, np.float32(coeffs.a0)


@pytest.mark.parametrize("tol", [2e-4, 1e-5])
@pytest.mark.parametrize("kind", ["bar_tet", "bar_hex"])
def test_packed_matches_reference(kind, tol):
    jm, tm, rhs, mf = _bar(kind == "bar_hex")
    x0 = np.zeros_like(rhs)
    xj, telj, xt, telt = _both((jm, tm), rhs, x0, np.float32(1.0), mf, tol,
                               2000, warm_start=False)
    slack = 1 if tol >= 2e-4 else max(3, int(0.2 * int(telj.iterations)))
    _assert_match(xj, telj, xt, telt, slack)


def test_zero_rhs_and_max_iterations_zero():
    jm, tm, rhs, x0 = _problem()
    zeros = np.zeros_like(rhs)
    for r, x, max_it in ((zeros, zeros, 100), (rhs, x0, 0)):
        xj, telj, xt, telt = _both((jm, tm), r, x, SS, MF, 1e-6, max_it)
        assert telt.iterations == int(telj.iterations) == 0
        assert telt.converged == bool(telj.converged) == (max_it > 0)
        assert np.isfinite(float(telt.residual_norm))
        assert float(telt.residual_norm) == pytest.approx(
            float(telj.residual_norm), rel=1e-6)
        np.testing.assert_array_equal(xt, xj)


class _CountingModel:
    """A model whose apply_pc_keff calls are counted."""

    def __init__(self, model):
        self._model = model
        self.pc_keff_calls = 0

    def __getattr__(self, name):
        return getattr(self._model, name)

    def apply_pc_keff(self, *args):
        self.pc_keff_calls += 1
        return self._model.apply_pc_keff(*args)


@pytest.mark.parametrize("replace_every, tol", [(0, 2e-4), (4, 1e-7)])
def test_pc_keff_count(replace_every, tol):
    _, tm, rhs, x0 = _problem()
    model = _CountingModel(tm)
    _, tel = tpcg.solve_pcg(model, torch.from_numpy(rhs), SS, MF, tol, 300,
                            torch.from_numpy(x0), variant="pipelined",
                            replace_every=replace_every)
    assert tel.converged and tel.iterations > 8
    # replacements follow the updates of iterations 0..n-1 where
    # (i + 1) % replace_every == 0
    replacements = tel.iterations // replace_every if replace_every else 0
    assert model.pc_keff_calls == 1 + (tel.iterations + 1) + replacements


def test_replace_every_reaches_the_solver(monkeypatch):
    from civiwave_tpu_torch.parallel.sharding import (
        close_shard_group,
        make_shard_group,
        shard_simulation,
    )
    from civiwave_tpu_torch.runner import build_simulation, run_static
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    seen = []
    real = tpcg.solve_pcg_pipelined

    def spy(*args, replace_every, **kw):
        seen.append(replace_every)
        return real(*args, replace_every=replace_every, **kw)

    monkeypatch.setattr(tpcg, "solve_pcg_pipelined", spy)
    solver = {"type": "pcg", "preconditioner": "block_jacobi",
              "tol_runtime": 2e-4, "tol_pause": 1e-6, "max_iters": 300,
              "variant": "pipelined", "replace_every": 7}
    sim = build_simulation(cantilever_config(
        mesh={"path": "synthetic://box/5,3,3"}, solver=solver), device="cpu")
    assert sim.stepper.solver_replace_every == 7
    [tel] = sim.run(1)
    _, payload = run_static(sim, variant="pipelined")
    assert tel.pcg_converged and payload["converged"]
    group = make_shard_group(1, "cpu")
    try:
        shard = shard_simulation(sim, group)
        assert shard.stepper.solver_replace_every == 7
        [tel] = shard.run(1)
    finally:
        close_shard_group()
    assert tel.pcg_converged
    assert seen == [7, 7, 7]


def test_two_rank_shard_matches_one_rank(tmp_path):
    """examples/cantilever_box.yaml on a 15x4x4 box with the pipelined
    variant (replace_every 4) over two gloo ranks against one rank."""
    with open(os.path.join(REPO, "examples", "cantilever_box.yaml")) as f:
        node = yaml.safe_load(f)
    node["mesh"]["path"] = "synthetic://box/15,4,4"
    node["solver"].update(variant="pipelined", replace_every=4)
    scenario = tmp_path / "pipelined.yaml"
    scenario.write_text(yaml.safe_dump(node))
    out = tmp_path / "frames.npz"
    cmd = [sys.executable, "-m", "civiwave_tpu_torch.parallel.launch",
           "--npx", "2", "--scenario", str(scenario), "--frames", "4",
           "--device", "cpu", "--init-method", f"file://{tmp_path / 'store'}",
           "--timeout", str(JOIN_TIMEOUT // 2 - 5), "--out", str(out),
           "--against-one-rank"]
    [(rc, log)] = _run_ranks([cmd], tmp_path)
    assert rc == 0, log
    assert "against one rank: iterations" in log and "FAIL" not in log, log
    got = np.load(out)
    iters = got["iterations"]
    assert got["converged"].all() and iters.sum() > 0
    # one f64 (3,) all-reduce per loop body: every iteration and the body
    # that stops (a frame converged before the loop runs none)
    assert int(got["psum_f64_3"]) == int(sum(n + 1 for n in iters if n > 0))
