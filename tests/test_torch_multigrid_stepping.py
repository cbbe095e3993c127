"""Newmark stepping under the port's geometric multigrid.

* 3 frames of the port's ``newmark_step`` on a multigrid model against the
  reference's (``civiwave_tpu.solver.stepper.newmark_step``, jitted) on the
  same hierarchy: iterations within +-1 per frame, u and a at the BASELINE
  stepping tolerances (2.5e-4 and 3e-3 of max|ref|).  The reference's
  model takes the reference's own coarse level (``_coarsen_model``) and
  the port's omegas (``tests/test_torch_multigrid.py`` holds those to the
  reference's at rtol 1e-3), which spares its power-iteration compiles;
* ``solver.preconditioner: multigrid`` through ``build_simulation`` on the
  CPU on 'auto' (= classic under multigrid) and 'pipelined': 3 frames
  against block-Jacobi classic at the same tolerances, in fewer
  iterations.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from civiwave_tpu.ops import multigrid as jmg
from civiwave_tpu.solver.stepper import newmark_step as jnewmark_step
from civiwave_tpu_torch.ops import multigrid as tmg
from civiwave_tpu_torch.physics import materials as tmaterials
from civiwave_tpu_torch.runner import build_simulation
from civiwave_tpu_torch.solver.stepper import newmark_step
from civiwave_tpu_torch.utils.synthetic import cantilever_config

from test_torch_structured import build_pair

torch.set_num_threads(2)

U_TOL, A_TOL = 2.5e-4, 3e-3
FIXTURE = ((10, 6, 6), dict(traction=(0.0, 0.0, -1.0e6), pad_x_multiple=4))


def test_newmark_trajectory_matches_reference():
    jm, jf, tm, _ = build_pair(*FIXTURE)
    ta = tmg.attach_multigrid(tm)
    coarse = jmg._coarsen_model(jm)
    assert len(ta.mg_levels) == 1 and coarse.grid_shape == ta.mg_levels[0].grid_shape
    ja = dataclasses.replace(jm, mg_levels=(coarse,), mg_omegas=ta.mg_omegas,
                             preconditioner="multigrid")
    ray = tmaterials.compute_rayleigh(cantilever_config().damping)
    kw = dict(rayleigh_alpha=ray.alpha, rayleigh_beta=ray.beta)
    jstep = jax.jit(lambda m, s, f: jnewmark_step(m, s, f, 1.0e-3, 2e-4, 200, **kw))
    js, ts = ja.zero_state(), ta.zero_state()
    force = torch.from_numpy(np.array(jf))
    for _ in range(3):
        jout = jstep(ja, js, jf)
        tout = newmark_step(ta, ts, force, 1.0e-3, 2e-4, 200, **kw)
        js, ts = jout.state, tout.state
        assert tout.pcg.converged and bool(jout.pcg.converged)
        assert tout.pcg.iterations > 0
        assert abs(tout.pcg.iterations - int(jout.pcg.iterations)) <= 1
    for field, tol in (("displacement", U_TOL), ("acceleration", A_TOL)):
        want = np.asarray(getattr(js, field))
        np.testing.assert_allclose(getattr(ts, field).numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max(), err_msg=field)


@pytest.mark.parametrize("variant", ["auto", "pipelined"])
def test_build_simulation_multigrid(variant):
    node = dict(mesh={"path": "synthetic://box/12,4,4"})
    solver = {"type": "pcg", "tol_runtime": 1e-6, "tol_pause": 1e-8,
              "max_iters": 400, "variant": variant}
    sim = build_simulation(cantilever_config(
        **node, solver={**solver, "preconditioner": "multigrid"}), device="cpu")
    ref = build_simulation(cantilever_config(
        **node, solver={**solver, "preconditioner": "block_jacobi",
                        "variant": "classic"}), device="cpu")
    assert sim.model.multigrid and not ref.model.multigrid
    assert sim.stepper.solver_variant == variant
    tel, ref_tel = sim.run(3), ref.run(3)
    assert all(t.pcg_converged for t in tel + ref_tel)
    assert sum(t.pcg_iterations for t in tel) < sum(
        t.pcg_iterations for t in ref_tel)
    for field, tol in (("displacement", U_TOL), ("acceleration", A_TOL)):
        want = getattr(ref.stepper, field)()
        np.testing.assert_allclose(getattr(sim.stepper, field)(), want, rtol=0,
                                   atol=tol * np.abs(want).max(), err_msg=field)
