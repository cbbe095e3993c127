"""The sharded general path and the structured route's new shard cases
across gloo ranks, against the JAX reference's single-device results.

Each world runs ``tests/torch_general_sharded_support.py``, one process
per rank, killed after ``JOIN_TIMEOUT``; each case is held to the
reference's single-device step at 1e-5 * max|u| (test_sharding.py:
1001-1023), statics at 2.5e-4:

* one Newmark step through the halo operator on 2 ranks (tet) and 4
  (hex), with the fused loop's budget: one f64 (3,) all-reduce and 2
  ghost exchanges per PCG iteration, no all-gather (:1026-1063);
* the fallbacks, counted: ``CIVIWAVE_GENERAL_HALO=0`` on 2 ranks and the
  bar on 8 (no plan): one all-gather per matvec, no exchange (:1066-1078);
* absorbing faces ("x1", "y0", "y1", "z0") on 4 slabs and on 2x2 tiles
  (:523, :904);
* static solves on 2 ranks, general (tet) and structured.

The plan and the in-process shard operator are
``tests/test_torch_general_halo.py``.
"""

import functools
import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest

from civiwave_tpu.mesh import pack as jpack
from civiwave_tpu.mesh import preprocess as jpreprocess
from civiwave_tpu.mesh import structured as jstructured
from civiwave_tpu.physics import materials as jmaterials
from civiwave_tpu.solver.static import solve_static_jit
from civiwave_tpu.solver.stepper import newmark_step as jnewmark_step
from civiwave_tpu.utils import synthetic as jsynthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUPPORT = os.path.join(REPO, "tests", "torch_general_sharded_support.py")
JOIN_TIMEOUT = 150  # seconds for all ranks of one run
STEP_TOL, STATIC_TOL = 1e-5, 2.5e-4
ABSORB = ["x1", "y0", "y1", "z0"]

# the gloo runs: world -> cases of the support script
RUNS = {
    2: [
        {"name": "tet_halo", "mesh": [20, 4, 3], "hex": False},
        {"name": "tet_halo_off", "mesh": [20, 4, 3], "hex": False,
         "env": {"CIVIWAVE_GENERAL_HALO": "0"}},
        {"name": "tet_static", "mesh": [12, 3, 3], "hex": False,
         "static": True},
        {"name": "grid_static", "grid": [9, 3, 3], "static": True},
    ],
    4: [
        {"name": "hex_halo", "mesh": [24, 3, 3], "hex": True},
        # one grid (the reference's 2-D fixture, :904) for both cuts, so
        # one reference step serves them
        {"name": "slabs_absorbing", "grid": [7, 5, 4], "absorb": ABSORB},
        {"name": "tiles_absorbing", "grid": [7, 5, 4], "npy": 2,
         "absorb": ABSORB},
    ],
    8: [{"name": "bar_gathered", "mesh": [4, 2, 2], "hex": False}],
}
CASES = {case["name"]: (world, case) for world, cases in RUNS.items()
         for case in cases}


@functools.lru_cache(maxsize=None)
def _run(world, tmp):
    """Every case of RUNS[world] over ``world`` gloo ranks: {name: npz}."""
    os.makedirs(tmp, exist_ok=True)
    cases = os.path.join(tmp, "cases.json")
    with open(cases, "w", encoding="utf-8") as handle:
        json.dump(RUNS[world], handle)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("CIVIWAVE_GENERAL_HALO", None)
    procs = [
        subprocess.Popen(
            [sys.executable, SUPPORT, "--rank", str(rank), "--world",
             str(world), "--init-method", f"file://{tmp}/store", "--cases",
             cases, "--out", tmp],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for rank in range(world)
    ]
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=JOIN_TIMEOUT)
            assert proc.returncode == 0, out
    except subprocess.TimeoutExpired:
        pytest.fail(f"ranks still running after {JOIN_TIMEOUT} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    return {case["name"]: dict(np.load(os.path.join(tmp, case["name"] + ".npz")))
            for case in RUNS[world]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("general_sharded")

    def get(name):
        world, _ = CASES[name]
        return _run(world, str(root / f"world{world}"))[name]

    return get


def _reference(case):
    """The reference's single-device result of a case: (u, a) in nodal
    rows (a None for statics)."""
    keys = ("mesh", "hex", "grid", "absorb", "static")
    return _reference_of(json.dumps({k: case.get(k) for k in keys}))


@functools.lru_cache(maxsize=None)
def _reference_of(key):
    case = json.loads(key)
    cfg = jsynthetic.cantilever_config()
    ray = jmaterials.compute_rayleigh(cfg.damping)
    if case["mesh"]:
        mesh = jsynthetic.box_mesh(*case["mesh"], hex_elements=case["hex"])
        pre = jpreprocess.run(mesh, cfg)
        mats = [jmaterials.make_properties(m) for m in cfg.materials]
        model, state, force = jpack.build_packed_model(mesh, pre, cfg, mats)
    else:
        mat = cfg.materials[0]
        model, force = jstructured.build_structured_model(
            *case["grid"], jmaterials.make_properties(mat), mat.density,
            traction=(0.0, 0.0, -1.0e6),
            absorb_planes=tuple(case["absorb"] or ()))
        state = model.zero_state()
    if case.get("static"):
        u, tel = solve_static_jit(model, force, tolerance=1e-8,
                                  max_iterations=4000)
        assert bool(tel.converged)
        return np.asarray(model.to_nodal(u)), None
    out = jax.jit(lambda m, s, f: jnewmark_step(
        m, s, f, 1.0e-3, 1.0e-7, 500, rayleigh_alpha=ray.alpha,
        rayleigh_beta=ray.beta))(model, state, force)
    assert bool(out.pcg.converged)
    return (np.asarray(model.to_nodal(out.state.displacement)),
            np.asarray(model.to_nodal(out.state.acceleration)))


def _assert_matches(got, case, tol):
    u, a = _reference(case)
    assert bool(got["converged"])
    np.testing.assert_allclose(got["displacement"], u, rtol=0.0,
                               atol=tol * np.abs(u).max())
    if a is not None:
        np.testing.assert_allclose(got["acceleration"], a, rtol=0.0,
                                   atol=tol * np.abs(a).max())


@pytest.mark.parametrize("name", ["tet_halo", "hex_halo"])
def test_halo_step_matches_the_reference(runs, name):
    got = runs(name)
    world, case = CASES[name]
    assert int(got["halo_ranks"]) == world  # every rank ran the halo form
    _assert_matches(got, case, STEP_TOL)


@pytest.mark.parametrize("name", ["tet_halo", "hex_halo"])
def test_halo_budget_per_pcg_iteration(runs, name):
    """'auto' is fused under the halo operator: one f64 (3,) all-reduce
    per iteration (one (4,) at setup), 2 exchanges per matvec (the step's
    Rayleigh, residual and setup matvecs, then one per iteration) and one
    for the preconditioner's ghost-row blocks; no all-gather."""
    got = runs(name)
    iters = int(got["iterations"])
    assert int(got["psum_f64_3"]) == iters
    assert int(got["psum_f64_4"]) == 1
    assert int(got["psum_calls"]) == iters + 1
    assert int(got["ppermute_calls"]) == 2 * (3 + iters) + 1
    assert int(got["all_gather_calls"]) == 0


@pytest.mark.parametrize("name", ["tet_halo_off", "bar_gathered"])
def test_fallbacks_gather_once_per_matvec(runs, name):
    """No plan (the bar at 8 ranks) or CIVIWAVE_GENERAL_HALO=0: the
    all-gather form, one all-gather per matvec of the classic loop (the
    step's Rayleigh and residual matvecs, then one per iteration), no
    exchange; the step equals the reference's."""
    got = runs(name)
    world, case = CASES[name]
    assert int(got["halo_ranks"]) == 0
    assert int(got["all_gather_calls"]) == 2 + int(got["iterations"])
    assert int(got["ppermute_calls"]) == 0
    _assert_matches(got, case, STEP_TOL)


@pytest.mark.parametrize("name", ["slabs_absorbing", "tiles_absorbing"])
def test_absorbing_shards_match_the_reference(runs, name):
    _assert_matches(runs(name), CASES[name][1], STEP_TOL)


@pytest.mark.parametrize("name", ["tet_static", "grid_static"])
def test_static_solve_on_two_ranks_matches_the_reference(runs, name):
    got = runs(name)
    _assert_matches(got, CASES[name][1], STATIC_TOL)
    if name == "tet_static":
        assert int(got["halo_ranks"]) == 2
