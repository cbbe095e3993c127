"""The sharded structured route across spawned gloo ranks.

Each test starts its ranks as processes of their own (a ``FileStore``
under ``tmp_path``, one thread each) and kills them if they outlast
``JOIN_TIMEOUT``, so a hang fails one test instead of the suite:

* ``tests/torch_sharded_support.py`` ranks: the exchanged ghost planes and
  rows equal the neighbours' edges (zero at the global ends), the mask's
  ghosts from shard time too, and the gathered sharded operator equals
  the unsharded one; a matvec makes 2 ghost exchanges on a 1-D group and
  4 on a 2-D one;
* ``python -m civiwave_tpu_torch.parallel.launch`` ranks: Newmark frames
  of a small cantilever against the reference's sharded ``newmark_step``
  on a device mesh of the same shape (the conftest's virtual CPU
  devices), at the stepping tolerances (iterations +-1, u 2.5e-4 and a
  3e-3 of max|ref|), and the collective budget: one f64 (3,) all-reduce
  per fused PCG iteration, one (4,) per frame's setup, and 2 or 4 ghost
  exchanges per matvec (each frame's Rayleigh, residual and setup
  matvecs, then one per iteration);
* the launcher's ``--against-one-rank`` check, and a scenario with a time
  curve and adaptive dt (``examples/cantilever_box.yaml``) through
  ``shard_simulation`` on two ranks against the unsharded run.  Every rank
  gathers its fields through the stepper after each frame.

World sizes 2 and 4 and a 2x2 group.
"""

import json
import os
import signal
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from civiwave_tpu.mesh import structured as jstructured
from civiwave_tpu.parallel import sharding as jsharding
from civiwave_tpu.physics import materials as jmaterials
from civiwave_tpu.solver.stepper import newmark_step
from civiwave_tpu_torch.utils.synthetic import cantilever_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUPPORT = os.path.join(REPO, "tests", "torch_sharded_support.py")
JOIN_TIMEOUT = 120  # seconds for all ranks of one test
U_TOL, A_TOL = 2.5e-4, 3e-3
FRAMES = 4

# name -> (cells, npx, npy, 2-D)
GROUPS = {
    "1d_2": ((7, 3, 3), 2, 1, False),
    "1d_4": ((15, 4, 4), 4, 1, False),  # Xl = 4: the overlap split
    "2d_2x2": ((9, 4, 5), 2, 2, True),  # a dead +Y row
}


def _run_ranks(commands, tmp_path):
    """Start every command at once in a session of its own; kill them all
    if they outlast JOIN_TIMEOUT.  Returns [(rc, output)]."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
        for cmd in commands
    ]
    results = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=JOIN_TIMEOUT)
            results.append((proc.returncode, out))
    except subprocess.TimeoutExpired:
        pytest.fail(f"ranks still running after {JOIN_TIMEOUT} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    return results


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_ghosts_and_operator_across_ranks(name, tmp_path):
    cells, npx, npy, two_d = GROUPS[name]
    init = f"file://{tmp_path / 'store'}"
    commands = [
        [sys.executable, SUPPORT, "--rank", str(rank), "--npx", str(npx),
         "--npy", str(npy), "--cells", ",".join(map(str, cells)),
         "--init-method", init, "--out", str(tmp_path / f"rank{rank}.json")]
        for rank in range(npx * npy)
    ]
    for rc, out in _run_ranks(commands, tmp_path):
        assert rc == 0, out
    for rank in range(npx * npy):
        with open(tmp_path / f"rank{rank}.json", encoding="utf-8") as handle:
            result = json.load(handle)
        assert result["ghost_err"] == 0.0
        assert result["bc_ghost_mismatch"] == 0
        assert result["end_nonzero"] == 0
        assert result["exchanges_per_matvec"] == (4 if two_d else 2)
        assert result["op_rel_err"] <= 1e-5


def _jax_frames(cells, npx, npy, two_d):
    """The reference's sharded newmark_step ('auto' = fused there too) on
    a mesh of the same shape: per frame (iterations, u, a) in nodal rows."""
    cfg = cantilever_config()
    mat = cfg.materials[0]
    ray = jmaterials.compute_rayleigh(cfg.damping)
    model, force = jstructured.build_structured_model(
        *cells, jmaterials.make_properties(mat), mat.density,
        traction=(0.0, 0.0, -1.0e6), pad_x_multiple=npx,
        pad_y_multiple=npy if two_d else 1,
    )
    if two_d:
        mesh = jsharding.make_device_mesh_2d(npx, npy)
        sm, state, sf = jsharding.shard_structured(
            model, model.zero_state(), force, mesh, axis_name_y="shard_y")
    else:
        mesh = jsharding.make_device_mesh(npx)
        sm, state, sf = jsharding.shard_structured(
            model, model.zero_state(), force, mesh)
    step = jax.jit(partial(newmark_step, rayleigh_alpha=ray.alpha,
                           rayleigh_beta=ray.beta))
    frames = []
    for _ in range(FRAMES):
        out = step(sm, state, sf, 1.0e-3, 2.0e-4, 120)
        state = out.state
        assert bool(out.pcg.converged)
        frames.append((int(out.pcg.iterations),
                       np.asarray(model.to_nodal(jnp.asarray(state.displacement))),
                       np.asarray(model.to_nodal(jnp.asarray(state.acceleration)))))
    return frames


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_launcher_frames_match_reference(name, tmp_path):
    cells, npx, npy, two_d = GROUPS[name]
    out = tmp_path / "frames.npz"
    cmd = [sys.executable, "-m", "civiwave_tpu_torch.parallel.launch",
           "--npx", str(npx), "--npy", str(npy),
           "--cells", ",".join(map(str, cells)), "--frames", str(FRAMES),
           "--device", "cpu", "--init-method", f"file://{tmp_path / 'store'}",
           "--timeout", str(JOIN_TIMEOUT - 10), "--out", str(out)]
    [(rc, log)] = _run_ranks([cmd], tmp_path)
    assert rc == 0, log
    got = np.load(out)
    assert got["converged"].all()
    ref = _jax_frames(cells, npx, npy, two_d)
    iters = got["iterations"]
    for k, (it, u, a) in enumerate(ref):
        assert abs(int(iters[k]) - it) <= 1, (iters, [f[0] for f in ref])
        for field, want, tol in (("displacement", u, U_TOL),
                                 ("acceleration", a, A_TOL)):
            np.testing.assert_allclose(
                got[field][k], want, rtol=0.0,
                atol=tol * np.abs(want).max(), err_msg=f"{field} frame {k}")
    # the collective budget of the fused loop on a shard
    total = int(iters.sum())
    assert int(got["psum_f64_3"]) == total
    assert int(got["psum_f64_4"]) == FRAMES
    assert int(got["psum_calls"]) == total + FRAMES
    matvecs = 3 * FRAMES + total
    assert int(got["ppermute_calls"]) == (4 if two_d else 2) * matvecs


def test_launcher_against_one_rank(tmp_path):
    """2x2 tiles against one rank through the launcher's own check."""
    cmd = [sys.executable, "-m", "civiwave_tpu_torch.parallel.launch",
           "--npx", "2", "--npy", "2", "--cells", "9,4,5", "--frames", "3",
           "--device", "cpu", "--init-method", f"file://{tmp_path / 'store'}",
           "--timeout", str(JOIN_TIMEOUT // 2 - 5), "--against-one-rank"]
    [(rc, log)] = _run_ranks([cmd], tmp_path)
    assert rc == 0, log
    assert "against one rank: iterations" in log and "FAIL" not in log, log


def test_launcher_steps_a_curve_scenario(tmp_path):
    """examples/cantilever_box.yaml over two ranks: the force schedule's
    ramp is cut per shard, and frames, dt and fields follow the unsharded
    fused run."""
    import torch

    from civiwave_tpu_torch.runner import build_simulation

    scenario = os.path.join(REPO, "examples", "cantilever_box.yaml")
    out = tmp_path / "frames.npz"
    cmd = [sys.executable, "-m", "civiwave_tpu_torch.parallel.launch",
           "--npx", "2", "--scenario", scenario, "--frames", str(FRAMES + 1),
           "--device", "cpu", "--init-method", f"file://{tmp_path / 'store'}",
           "--timeout", str(JOIN_TIMEOUT - 10), "--out", str(out)]
    [(rc, log)] = _run_ranks([cmd], tmp_path)
    assert rc == 0, log
    got = np.load(out)
    ref = build_simulation(scenario, device=torch.device("cpu"))
    ref.stepper.solver_variant = "fused"  # 'auto' on a shard
    for k, tel in enumerate(ref.run(FRAMES + 1)):
        assert abs(int(got["iterations"][k]) - tel.pcg_iterations) <= 1
        assert got["time_step"][k] == tel.time_step
    for field, tol in (("displacement", U_TOL), ("acceleration", A_TOL)):
        want = getattr(ref.stepper, field)()
        np.testing.assert_allclose(got[field][-1], want, rtol=0.0,
                                   atol=tol * np.abs(want).max(), err_msg=field)


def test_launcher_needs_a_gpu_per_rank():
    """More ranks than visible GPUs: a clean refusal, no CPU fallback."""
    import torch

    from civiwave_tpu_torch.parallel import launch

    n = torch.cuda.device_count() + 1
    assert launch.main(["--npx", str(n), "--device", "cuda"]) == 1
