"""The port's vec3 helpers and interactive session (``civiwave_tpu_torch.
utils.vec3``, ``civiwave_tpu_torch.ui``): the cases of ``tests/test_ui.py``
against the port, on the CPU, and the port's session against the JAX
package's.

* vec3: the reference's math.hpp invariants (8 cases of its
  test_sample.cpp), and the port's results equal the JAX package's;
* the session on ``tests/data/cantilever.yaml`` (Gmsh tets, the general
  path): repeated solves are bit-equal, a point load deflects its node, a
  degenerate direction is -Z, reset restores the baseline; the display
  stress overlay's directional decay;
* the port's solve against the JAX ``InteractiveSession.solve`` on the
  same scenario (``tests/data/cantilever.yaml``), with and without a
  point load: iterations within 1, u within 2.5e-4 and a within 3e-3 of
  max|JAX| (BASELINE's stepping tolerances), node von Mises within 3e-3
  of its max;
* two equal requests give bit-equal states (u, v, a, the warm start) and
  reset restores the baseline exactly, on classic, fused, the megafused
  loop (``CIVIWAVE_MEGA_PCG=1``) and pipelined with ``warm_start_policy:
  solution``, where the loops' seed is the state's own warm start.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from civiwave_tpu.runner import build_simulation as jax_build
from civiwave_tpu.ui import InteractiveSession as JaxSession
from civiwave_tpu.ui import PointLoadRequest as JaxRequest
from civiwave_tpu.utils import vec3 as jvec3
from civiwave_tpu_torch.config.loader import load_config_from_file
from civiwave_tpu_torch.runner import build_simulation
from civiwave_tpu_torch.ui import InteractiveSession, PointLoadRequest
from civiwave_tpu_torch.utils.vec3 import cross, dot, magnitude, safe_normalize

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIO = os.path.join(REPO, "tests", "data", "cantilever.yaml")
U_TOL, A_TOL = 2.5e-4, 3e-3
FIELDS = ("displacement", "velocity", "acceleration", "warm_x")
BOX_YAML = """
mesh: {path: "synthetic://box/6,3,3"}
materials:
  - {name: steel, E: 2.0e11, nu: 0.3, rho: 7800.0}
assignments: [{group: SOLID, material: steel}]
damping: {xi: 0.02, w1: 10.0, w2: 100.0}
time: {dt: 0.002, adaptive: false, min_dt: 0.001, max_dt: 0.004}
solver: {type: pcg, preconditioner: block_jacobi, tol_runtime: 1.0e-6,
         tol_pause: 1.0e-8, max_iters: 300}
precision: {vectors: fp32, reductions: fp64}
loads:
  gravity: [0.0, 0.0, -9.81]
  tractions: [{group: LOAD_FACE, value: [0.0, 0.0, -2.0e5]}]
dirichlet: {fixes: [{group: FIXED, dof: [x, y, z]}]}
output: {vtu_stride: 1, probes: []}
"""


# --- math.hpp invariants (tests/test_sample.cpp, 8 cases) -------------------


def test_dot_symmetry_and_orthogonality():
    a, b = np.array([1.0, 2.0, 3.0]), np.array([-4.0, 5.0, 0.5])
    assert dot(a, b) == pytest.approx(dot(b, a))
    assert dot([1, 0, 0], [0, 1, 0]) == 0.0


def test_cross_right_handed_basis():
    np.testing.assert_allclose(cross([1, 0, 0], [0, 1, 0]), [0, 0, 1])
    np.testing.assert_allclose(cross([0, 1, 0], [0, 0, 1]), [1, 0, 0])


def test_cross_annihilates_parallel():
    a = np.array([2.0, -1.0, 0.5])
    np.testing.assert_allclose(cross(a, 3.0 * a), 0.0, atol=1e-15)


def test_cross_antisymmetry():
    a, b = np.array([1.0, 2.0, 3.0]), np.array([-4.0, 5.0, 0.5])
    np.testing.assert_allclose(cross(a, b), -cross(b, a))


def test_magnitude_pythagorean():
    assert magnitude([3.0, 4.0, 0.0]) == pytest.approx(5.0)


def test_safe_normalize_unit_result():
    v = safe_normalize([3.0, 4.0, 0.0])
    assert magnitude(v) == pytest.approx(1.0)
    np.testing.assert_allclose(v, [0.6, 0.8, 0.0])


def test_safe_normalize_zero_vector_is_zero():
    """math.hpp:181-191 — below-threshold input gives exact zero, not NaN."""
    np.testing.assert_array_equal(safe_normalize([0.0, 0.0, 0.0]), 0.0)
    np.testing.assert_array_equal(safe_normalize([1e-13, 0.0, 0.0]), 0.0)


def test_safe_normalize_nonfinite_is_zero():
    np.testing.assert_array_equal(safe_normalize([np.inf, 0.0, 0.0]), 0.0)
    np.testing.assert_array_equal(safe_normalize([np.nan, 1.0, 0.0]), 0.0)


def test_safe_normalize_batched():
    vs = np.array([[3.0, 4.0, 0.0], [0.0, 0.0, 0.0]])
    out = safe_normalize(vs)
    np.testing.assert_allclose(out[0], [0.6, 0.8, 0.0])
    np.testing.assert_array_equal(out[1], 0.0)


def test_vec3_equals_the_reference():
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((2, 50, 3))
    a[:5] *= 1e-14  # below the threshold
    a[5, 0] = np.inf
    for ours, ref, args in ((dot, jvec3.dot, (a, b)), (cross, jvec3.cross, (a, b)),
                            (magnitude, jvec3.magnitude, (a,)),
                            (safe_normalize, jvec3.safe_normalize, (a,))):
        np.testing.assert_array_equal(ours(*args), ref(*args))


# --- interactive session (viewer.cpp SimulationBackend) ---------------------


def _general_sim():
    """tests/data/cantilever.yaml with its Gmsh path made absolute."""
    cfg = load_config_from_file(SCENARIO)
    cfg = dataclasses.replace(cfg, mesh_path=os.path.join(REPO, cfg.mesh_path))
    return build_simulation(cfg, device="cpu")


@pytest.fixture(scope="module")
def session():
    sim = _general_sim()
    return sim, InteractiveSession(sim)


def test_interactive_solve_is_repeatable(session):
    """Every solve restarts from the baseline (viewer.cpp:255-278), so the
    same request must yield the same state."""
    sim, ses = session
    req = PointLoadRequest(
        enabled=True, anchor=3, direction=(0, 0, -1), magnitude_newtons=1e4
    )
    tel1, derived1 = ses.solve(req)
    u1 = sim.stepper.displacement()
    tel2, derived2 = ses.solve(req)
    u2 = sim.stepper.displacement()
    np.testing.assert_array_equal(u1, u2)
    assert tel1.pcg_converged and tel2.pcg_converged
    np.testing.assert_array_equal(
        derived1.node_von_mises, derived2.node_von_mises
    )


def test_point_load_changes_solution(session):
    sim, ses = session
    ses.solve(PointLoadRequest(enabled=False))
    u_free = sim.stepper.displacement()
    ses.solve(
        PointLoadRequest(
            enabled=True, anchor=3, direction=(0, 0, -1), magnitude_newtons=1e5
        )
    )
    u_loaded = sim.stepper.displacement()
    # the loaded solve deflects the free node further down
    assert u_loaded[3, 2] < u_free[3, 2]


def test_degenerate_direction_falls_back_minus_z(session):
    """viewer.cpp:327-333: near-zero direction becomes (0, 0, -1)."""
    sim, ses = session
    ses.solve(
        PointLoadRequest(
            enabled=True, anchor=3, direction=(0.0, 0.0, 0.0),
            magnitude_newtons=1e5,
        )
    )
    u_degenerate = sim.stepper.displacement()
    ses.solve(
        PointLoadRequest(
            enabled=True, anchor=3, direction=(0.0, 0.0, -1.0),
            magnitude_newtons=1e5,
        )
    )
    u_explicit = sim.stepper.displacement()
    np.testing.assert_array_equal(u_degenerate, u_explicit)


def test_reset_restores_baseline(session):
    sim, ses = session
    ses.solve(
        PointLoadRequest(enabled=True, anchor=3, magnitude_newtons=1e5)
    )
    ses.reset()
    np.testing.assert_array_equal(sim.stepper.displacement(), 0.0)


def test_display_stress_overlay_directional_decay():
    """Host twin of recompute_display_stress (viewer.cpp:2940-2999):
    anchor gets the full boost, aligned vertices decay exponentially with
    distance, anti-aligned vertices are untouched."""
    from civiwave_tpu_torch.ui.session import (
        display_stress_overlay,
        estimate_auto_falloff,
        stress_reference_range,
    )

    pos = np.array(
        [[0.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0], [-1.0, 0, 0]], np.float64
    )
    vm = np.array([10.0, 5.0, 2.0, 4.0])
    req = PointLoadRequest(
        enabled=True, anchor=0, direction=(1.0, 0.0, 0.0),
        magnitude_newtons=1.0,
    )
    display, falloff = display_stress_overlay(pos, vm, req)
    assert 0.05 <= falloff <= 2.0
    ref = stress_reference_range(vm)
    assert display[0] == pytest.approx(vm[0] + ref)  # anchor: full boost
    assert display[3] == pytest.approx(vm[3])  # anti-aligned: untouched
    b1, b2 = display[1] - vm[1], display[2] - vm[2]
    assert b1 > b2 > 0.0  # exponential decay along the direction
    assert b1 / b2 == pytest.approx(np.exp(falloff), rel=1e-5)

    display_off, _ = display_stress_overlay(
        pos, vm, PointLoadRequest(enabled=False)
    )
    np.testing.assert_allclose(display_off, vm)
    assert estimate_auto_falloff(pos, np.zeros(4), 0) == pytest.approx(0.35)


# --- the port's session against the JAX package's ---------------------------


@pytest.fixture(scope="module")
def box_yaml(tmp_path_factory):
    path = tmp_path_factory.mktemp("session") / "box.yaml"
    path.write_text(BOX_YAML)
    return str(path)


@pytest.fixture(scope="module")
def pair():
    """The port's and the JAX package's session on the same scenario,
    built once (every solve restarts from the baseline)."""
    sim, jsim = _general_sim(), jax_build(SCENARIO, mesh_root=REPO)
    return (sim, InteractiveSession(sim)), (jsim, JaxSession(jsim))


@pytest.mark.parametrize("loaded", [False, True], ids=["free", "point_load"])
def test_session_matches_reference(loaded, pair):
    (sim, ses), (jsim, jses) = pair
    anchor = sim.model.node_count - 1
    kw = dict(enabled=loaded, anchor=anchor, direction=(0.3, -0.2, -1.0),
              magnitude_newtons=2e5)
    tel, derived = ses.solve(PointLoadRequest(**kw))
    jtel, jderived = jses.solve(JaxRequest(**kw))
    assert tel.pcg_converged and jtel.pcg_converged
    assert abs(tel.pcg_iterations - jtel.pcg_iterations) <= 1
    for ours, ref, tol in (
            (sim.stepper.displacement(), jsim.stepper.displacement(), U_TOL),
            (sim.stepper.acceleration(), jsim.stepper.acceleration(), A_TOL),
            (derived.node_von_mises, jderived.node_von_mises, A_TOL)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours, ref, rtol=0.0,
                                   atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("variant", ["classic", "fused", "megafused",
                                     "pipelined"])
def test_equal_requests_give_bit_equal_states(variant, box_yaml, monkeypatch):
    """The loops write their vectors in place (the megafused one x, u and
    p; with warm_start_policy 'solution' x starts as the state's warm
    start): the session's clones keep the baseline, so equal requests and
    reset are exact."""
    if variant == "megafused":
        monkeypatch.setenv("CIVIWAVE_MEGA_PCG", "1")
    sim = build_simulation(box_yaml, device="cpu")
    sim.run(2)  # a non-zero baseline with a warm start
    sim.stepper.solver_variant = "fused" if variant == "megafused" else variant
    sim.stepper.warm_start_policy = "solution"
    baseline = [getattr(sim.stepper.state, f).clone() for f in FIELDS]
    ses = InteractiveSession(sim)
    req = PointLoadRequest(enabled=True, anchor=sim.model.node_count - 1,
                           direction=(0, 0, -1), magnitude_newtons=1e5)
    states = []
    for _ in range(2):
        ses.solve(req)
        states.append([getattr(sim.stepper.state, f).clone() for f in FIELDS])
    for f, a, b in zip(FIELDS, *states):
        assert torch.equal(a, b), f
    ses.reset()
    for f, want in zip(FIELDS, baseline):
        assert torch.equal(getattr(sim.stepper.state, f), want), f
    assert not torch.equal(states[0][0], baseline[0])
