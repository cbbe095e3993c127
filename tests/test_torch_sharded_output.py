"""Checkpoints, output, derived fields and probes of a shard, across
spawned gloo ranks (``tests/torch_sharded_output_support.py``).

Four groups run at once in a module fixture, each killed after
``JOIN_TIMEOUT``: the homogeneous cantilever over 2x1 and 2x2 ranks (a
dead +Y row on 2x2), the heterogeneous one over 2x1 (G3's plain shard
version) and the 4x2x2 tet box over 2 ranks of the general path.  Each
rank steps 4 frames with output and a checkpoint every 2 frames, then a
new build resumes from the checkpoint of frame 2.  Held here:

* the resumed run equals the uninterrupted one bit for bit (u, v, a, the
  warm start, dt, clock and frame; the reference pins this for its
  sharded 2-D state, ``tests/test_checkpoint.py:52``), and the one file
  rank 0 wrote is the unsharded format: it restores bit-equal into the
  unsharded build of the same padding;
* the output directory holds the files an unsharded run writes, and each
  file equals, byte for byte, what the unsharded manager writes for the
  same gathered states (the derived fields and probe rows come from the
  same bits, so the VTU arrays and ``probes.csv`` are bit-equal; the
  looser bound of 1e-6 of max|.| is not needed);
* the shard's gathered derived fields against the JAX package's
  ``compute_structured_derived`` on the same state, at
  ``tests/test_torch_post.py``'s tolerance (1e-6 of max|.| per field);
* the collectives the output makes per frame: a VTU frame exchanges u's
  ghosts once (2 ``ppermute`` in 1-D, 4 in 2-D) and gathers the six
  derived fields and u, v, a (9) plus the probe samples (1); any other
  frame makes one gather; the general path gathers u, v and a (3) every
  frame and exchanges nothing.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from civiwave_tpu.mesh import structured as jstructured
from civiwave_tpu.physics import materials as jmaterials
from civiwave_tpu.post import structured_fields as jfields
from civiwave_tpu_torch.mesh.pack import SimState
from civiwave_tpu_torch.post.output import StructuredOutputManager
from civiwave_tpu_torch.utils.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))

import torch_sharded_output_support as support  # noqa: E402
from test_torch_sharded_path import JOIN_TIMEOUT  # noqa: E402
from torch_sharded_support import hetero_cells  # noqa: E402

torch.set_num_threads(2)

SCRIPT = os.path.join(REPO, "tests", "torch_sharded_output_support.py")
# name -> (route, npx, npy)
GROUPS = {
    "structured_2x1": ("structured", 2, 1),
    "structured_2x2": ("structured", 2, 2),
    "hetero_2x1": ("hetero", 2, 1),
    "general_2": ("general", 2, 1),
}
STRUCTURED = [n for n, (route, _, _) in GROUPS.items() if route != "general"]
NAMES = ("element_strain", "element_stress", "element_von_mises",
         "node_strain", "node_stress", "node_von_mises")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group's ranks at once; {name: (result npz, its directory)}."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs, dirs = [], {}
    for name, (route, npx, npy) in GROUPS.items():
        d = tmp_path_factory.mktemp(name)
        dirs[name] = d
        for rank in range(npx * npy):
            cmd = [sys.executable, SCRIPT, "--rank", str(rank), "--npx",
                   str(npx), "--npy", str(npy), "--route", route,
                   "--init-method", f"file://{d / 'store'}", "--out", str(d)]
            procs.append(subprocess.Popen(
                cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, start_new_session=True))
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=JOIN_TIMEOUT)
            assert proc.returncode == 0, out
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {name: (np.load(d / "result.npz"), d) for name, d in dirs.items()}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("name", list(GROUPS))
def test_resumed_run_equals_the_uninterrupted_run(name, runs):
    result, _ = runs[name]
    assert int(result["resumed_from"]) == 3  # saved after frame 2
    assert result["steps"].tolist() == [3]
    assert result["resumed_equal"].all()
    assert bool(result["scalars_equal"])


@pytest.mark.parametrize("name", list(GROUPS))
def test_the_checkpoint_restores_into_the_unsharded_build(name, runs):
    """Rank 0 wrote one file of the padded global model: the unsharded
    build of the same padding restores frame 2's gathered state bit for
    bit."""
    result, d = runs[name]
    route, npx, npy = GROUPS[name]
    assert os.listdir(d / "ck") == ["frame_00000003.pt"]
    sim = support.build(route, npx, npy)
    assert sim.stepper.restore_checkpoint(CheckpointManager(str(d / "ck"))) == 3
    for key, field in zip("uva", support.FIELDS):
        assert np.array_equal(getattr(sim.stepper.state, field).numpy(),
                              result[key][2]), field
    assert sim.stepper.accumulated_time == pytest.approx(3e-3, abs=0)


class _Frame:
    """What an output manager reads of a stepper: its model and state."""

    def __init__(self, model, u, v, a):
        self.model = model
        self.state = SimState(*(torch.from_numpy(t) for t in (u, v, a, u)))


def _replay(name, result, root):
    """The unsharded manager's files for the group's gathered states."""
    route, npx, npy = GROUPS[name]
    sim = support.build(route, npx, npy, str(root))
    model, manager = sim.model, sim.output
    for frame, t in enumerate(result["t"]):
        u, v, a = (result[k][frame] for k in "uva")
        if route == "general":
            u, v, a = (model.to_nodal(torch.from_numpy(x)).numpy()
                       for x in (u, v, a))
            manager.handle_frame(float(t), frame, u, v, a)
        else:
            assert isinstance(manager, StructuredOutputManager)
            manager.handle_from_stepper(float(t), frame,
                                        _Frame(model, u, v, a))
    manager.flush()


@pytest.mark.parametrize("name", list(GROUPS))
def test_output_equals_the_unsharded_managers(name, runs, tmp_path):
    result, d = runs[name]
    _replay(name, result, tmp_path)
    files = _files(tmp_path)
    assert files == ["probes/probes.csv", "vtu/frame_00000.vtu",
                     "vtu/frame_00002.vtu"]
    assert _files(d / "out") == files
    for f in files:
        got, want = (open(r / f, "rb").read() for r in (d / "out", tmp_path))
        assert got == want, f
    rows = open(tmp_path / "probes" / "probes.csv").read().splitlines()
    probes = support.TET_PROBES if name == "general_2" else support.PROBES
    assert len(rows) == 1 + support.FRAMES * len(probes)


def _jax_model(route, npx, npy):
    mat = support.scenario(route).materials[0]
    kw = {}
    if route == "hetero":
        lam, mu = hetero_cells(support.CELLS)
        kw = dict(lam_grid=lam, mu_grid=mu)
    model, _ = jstructured.build_structured_model(
        *support.CELLS, jmaterials.make_properties(mat), mat.density,
        pad_x_multiple=npx, pad_y_multiple=npy, **kw)
    return model


@pytest.mark.parametrize("name", STRUCTURED)
def test_shard_derived_fields_match_reference(name, runs):
    """The gathered fields of the last state against the JAX package's
    on the same u: element grids of the live cells, node grids of the
    padded grid, 1e-6 of max|.| per field."""
    result, _ = runs[name]
    jm = _jax_model(*GROUPS[name])
    ref = jfields.compute_structured_derived(jm, jnp.asarray(result["u"][-1]))
    for i, (field, want) in enumerate(zip(NAMES, ref)):
        want = np.asarray(want)
        got = result[f"derived{i}"]
        assert got.shape == want.shape, field
        np.testing.assert_allclose(got, want, rtol=0.0,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=field)


@pytest.mark.parametrize("name", list(GROUPS))
def test_output_collectives_per_frame(name, runs):
    result, _ = runs[name]
    route, _, npy = GROUPS[name]
    if route == "general":
        assert result["ppermute"].tolist() == [0] * support.FRAMES
        assert result["gather"].tolist() == [3] * support.FRAMES
        return
    exchanges = 4 if npy > 1 else 2
    assert result["ppermute"].tolist() == [exchanges, 0, exchanges, 0]
    assert result["gather"].tolist() == [10, 1, 10, 1]


def test_probe_csv_holds_every_probe_once_per_frame(runs):
    """The 2x2 cut's probes include nodes on the slab and tile cuts, whose
    windows cross blocks: each row once per frame, in probe order."""
    _, d = runs["structured_2x2"]
    rows = open(d / "out" / "probes" / "probes.csv").read().splitlines()[1:]
    nodes = [int(re.split(",", r)[2]) for r in rows]
    assert nodes == list(support.PROBES) * support.FRAMES


def test_launcher_output_checkpoints_and_resume(tmp_path):
    """``parallel.launch --output --checkpoint-dir --checkpoint-every``
    over 2 ranks, then ``--resume``: the runner's file names, the saves
    at the cadence and after the run, the resume from the latest."""
    out, ck = tmp_path / "out", tmp_path / "ck"
    launch = [sys.executable, "-m", "civiwave_tpu_torch.parallel.launch",
              "--npx", "2", "--cells", "9,4,5", "--device", "cpu",
              "--timeout", str(JOIN_TIMEOUT), "--checkpoint-dir", str(ck)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for extra in (["--frames", "3", "--output", str(out),
                   "--checkpoint-every", "2"], ["--frames", "1", "--resume"]):
        run = subprocess.run(launch + extra, cwd=REPO, env=env, text=True,
                             capture_output=True, timeout=JOIN_TIMEOUT + 30)
        assert run.returncode == 0, run.stdout + run.stderr
    assert "resumed from checkpoint at frame 3" in run.stdout
    assert sorted(os.listdir(ck)) == ["frame_00000003.pt", "frame_00000004.pt"]
    assert _files(out) == [f"vtu/frame_0000{i}.vtu" for i in range(3)]
