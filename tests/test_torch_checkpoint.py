"""Checkpoints, resume and ``--profile`` of the port (the reference's
``utils/checkpoint.py``, its stepper's ``save_checkpoint`` /
``restore_checkpoint``, ``Simulation.run``'s ``checkpoint_every`` and the
CLI's ``--checkpoint-dir``, ``--checkpoint-every``, ``--resume`` and
``--profile``), on the CPU:

* a run of N frames equals one checkpointed at frame k and resumed from a
  new ``build_simulation``, bit for bit (u, v, a, the warm start, dt, the
  clock and the frame), on the structured route with a curve-ramped load
  and adaptive dt, on the general path and in fp64;
* ``max_to_keep`` prunes the oldest files; an interrupted write leaves no
  file the manager lists; a checkpoint of another layout or precision
  raises CwfError; a one-rank group's checkpoint restores into the
  unsharded build of the same padding and back, bit for bit, and its
  output is written;
* the CLI: the cadence, ``--checkpoint-every 0`` (the final save only),
  ``--resume`` with and without a checkpoint, and a ``--profile`` trace
  that names the reference's ranges.
"""

import glob
import json
import os

import pytest
import torch

from civiwave_tpu_torch.runner import build_simulation, main
from civiwave_tpu_torch.utils import profiling
from civiwave_tpu_torch.utils.checkpoint import CheckpointManager
from civiwave_tpu_torch.utils.errors import CwfError
from civiwave_tpu_torch.utils.synthetic import cantilever_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_YAML = os.path.join(REPO, "examples", "cantilever_box.yaml")
FIELDS = ("displacement", "velocity", "acceleration", "warm_x")

SCENARIOS = {
    # 24x8x8 hexes: gravity, a curve-ramped traction, adaptive dt
    "structured_box": lambda tmp: BOX_YAML,
    "general_tet_box": lambda tmp: cantilever_config(
        mesh={"path": "synthetic://box/4,2,2,tet"}, tol_runtime=2e-4,
        adaptive=True),
    "structured_fp64": lambda tmp: cantilever_config(
        mesh={"path": "synthetic://box/6,3,3"}, tol_runtime=1e-8,
        precision={"vectors": "fp64", "reductions": "fp64"}),
}


def _assert_same_run(a, b):
    for name in FIELDS:
        assert torch.equal(getattr(a.stepper.state, name),
                           getattr(b.stepper.state, name)), name
    assert a.stepper.current_dt == b.stepper.current_dt
    assert a.stepper.accumulated_time == b.stepper.accumulated_time
    assert a.stepper.frame_index == b.stepper.frame_index


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_resumed_run_equals_unbroken_run(name, tmp_path):
    scenario = SCENARIOS[name](tmp_path)
    frames, k = 6, 3
    unbroken = build_simulation(scenario, device="cpu")
    tel = unbroken.run(frames)

    first = build_simulation(scenario, device="cpu")
    manager = CheckpointManager(str(tmp_path / "ck"))
    first.run(k + 1, checkpoint_manager=manager, checkpoint_every=k)
    manager.wait()
    assert manager.steps() == [k + 1]  # saved after frame k, next frame k + 1
    resumed = build_simulation(scenario, device="cpu")
    assert resumed.stepper.restore_checkpoint(manager) == k + 1
    rest = resumed.run(frames - k - 1)
    assert [t.pcg_iterations for t in rest] == [t.pcg_iterations for t in tel[k + 1:]]
    _assert_same_run(resumed, unbroken)


def test_max_to_keep_prunes_the_oldest(tmp_path):
    sim = build_simulation(cantilever_config(mesh={"path": "synthetic://box/3,2,2"}),
                           device="cpu")
    manager = CheckpointManager(str(tmp_path), max_to_keep=2)
    sim.run(7, checkpoint_manager=manager, checkpoint_every=2)
    sim.stepper.save_checkpoint(manager, wait=True)
    assert manager.steps() == [5, 7] and manager.latest_step() == 7
    state, dt, t, frame = manager.restore(7)
    assert frame == 7 and state.displacement.device.type == "cpu"
    with pytest.raises(FileNotFoundError):
        manager.restore(3)
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), max_to_keep=0)


def test_a_half_written_file_is_not_a_checkpoint(tmp_path):
    """A killed write leaves only its temporary name, which no listing or
    restore takes; an empty directory has no latest step."""
    manager = CheckpointManager(str(tmp_path))
    assert manager.latest_step() is None
    with pytest.raises(FileNotFoundError):
        manager.restore()
    (tmp_path / "frame_00000004.pt.1234.tmp").write_bytes(b"half")
    assert manager.steps() == [] and manager.latest_step() is None


@pytest.mark.parametrize("what", ["dtype", "shape"])
def test_restore_refuses_another_layout(what, tmp_path):
    cells = {"dtype": "3,2,2", "shape": "4,2,2"}[what]
    sim = build_simulation(cantilever_config(mesh={"path": "synthetic://box/3,2,2"}),
                           device="cpu")
    sim.run(1)
    manager = CheckpointManager(str(tmp_path))
    sim.stepper.save_checkpoint(manager, wait=True)
    other = build_simulation(cantilever_config(
        mesh={"path": f"synthetic://box/{cells}"},
        precision={"vectors": "fp64" if what == "dtype" else "fp32",
                   "reductions": "fp64"}), device="cpu")
    with pytest.raises(CwfError, match=what if what == "shape" else "precision"):
        other.stepper.restore_checkpoint(manager)


def test_fp64_zero_state_is_saved_in_f64(tmp_path):
    """Before its first frame an fp64 run holds the f32 zero state; its
    checkpoint is in the run's precision, so it restores."""
    cfg = cantilever_config(mesh={"path": "synthetic://box/3,2,2"},
                            precision={"vectors": "fp64", "reductions": "fp64"})
    sim = build_simulation(cfg, device="cpu")
    manager = CheckpointManager(str(tmp_path))
    sim.stepper.save_checkpoint(manager, wait=True)
    state, _, _, frame = manager.restore()
    assert frame == 0 and state.displacement.dtype == torch.float64
    assert build_simulation(cfg, device="cpu").stepper.restore_checkpoint(manager) == 0


def test_a_one_rank_group_checkpoint_moves_to_the_unsharded_build(tmp_path):
    """A one-rank group saves, restores and writes output: its checkpoint
    is one file of the padded global model, which the unsharded build of
    the same padding restores bit for bit, and the other way round; its
    output directory holds the unsharded run's files."""
    from civiwave_tpu_torch.parallel import sharding

    cfg = cantilever_config(mesh={"path": "synthetic://box/5,3,3"},
                            output={"vtu_stride": 2, "probes": [0, 37]})
    pads = dict(pad_x_multiple=2, pad_y_multiple=2)  # a pad plane, a dead row
    group = sharding.make_shard_group_2d(1, 1, "cpu")
    try:
        sim = sharding.shard_simulation(build_simulation(
            cfg, device="cpu", output_root=str(tmp_path / "out"), **pads), group)
        manager = CheckpointManager(str(tmp_path / "ck"))
        sim.run(3, checkpoint_manager=manager, checkpoint_every=2)
        manager.wait()
        assert manager.steps() == [3]
        plain = build_simulation(cfg, device="cpu", **pads)
        assert plain.stepper.restore_checkpoint(manager) == 3
        _assert_same_run(plain, sim)
        plain.run(1)
        plain.stepper.save_checkpoint(manager, wait=True)
        fresh = sharding.shard_simulation(
            build_simulation(cfg, device="cpu", **pads), group)
        assert fresh.stepper.restore_checkpoint(manager) == 4
        _assert_same_run(fresh, plain)
    finally:
        sharding.close_shard_group()
    out = tmp_path / "out"
    assert sorted(os.listdir(out / "vtu")) == ["frame_00000.vtu", "frame_00002.vtu"]
    with open(out / "probes" / "probes.csv", encoding="ascii") as f:
        assert len(f.read().splitlines()) == 1 + 3 * 2


def _cli(*args):
    return main([BOX_YAML, "--device", "cpu", "--quiet", *args])


def test_cli_checkpoint_every_3(tmp_path, capsys):
    ck = tmp_path / "ck"
    assert _cli("--frames", "7", "--checkpoint-dir", str(ck),
                "--checkpoint-every", "3") == 0
    # frames 3 and 6 save (next frames 4 and 7), then the final save of 7
    assert CheckpointManager(str(ck)).steps() == [4, 7]
    assert "ran 7 frames" in capsys.readouterr().out


def test_cli_checkpoint_every_0_saves_the_end_only(tmp_path):
    ck = tmp_path / "ck"
    assert _cli("--frames", "4", "--checkpoint-dir", str(ck),
                "--checkpoint-every", "0") == 0
    assert CheckpointManager(str(ck)).steps() == [4]


def test_cli_resume_continues_the_run(tmp_path, capsys):
    ck, tel = tmp_path / "ck", tmp_path / "tel.json"
    assert _cli("--frames", "3", "--checkpoint-dir", str(ck)) == 0
    assert _cli("--frames", "2", "--checkpoint-dir", str(ck), "--resume",
                "--telemetry-json", str(tel)) == 0
    assert "resumed from checkpoint at frame 3" in capsys.readouterr().out
    assert CheckpointManager(str(ck)).steps() == [3, 5]
    resumed = json.loads(tel.read_text())
    unbroken = build_simulation(BOX_YAML, device="cpu").run(5)
    assert [f["pcg_iterations"] for f in resumed] == [
        t.pcg_iterations for t in unbroken[3:]]
    assert [f["simulation_time"] for f in resumed] == [
        t.simulation_time for t in unbroken[3:]]


def test_cli_resume_with_an_empty_directory_starts_at_frame_0(tmp_path, capsys):
    ck = tmp_path / "ck"
    assert _cli("--frames", "2", "--checkpoint-dir", str(ck), "--resume") == 0
    assert "resumed" not in capsys.readouterr().out
    assert CheckpointManager(str(ck)).steps() == [2]


def test_cli_profile_writes_a_trace_with_the_named_ranges(tmp_path, capsys):
    out = tmp_path / "trace"
    assert _cli("--frames", "2", "--profile", str(out)) == 0
    [path] = glob.glob(str(out / "*.json"))
    assert f"profile: {path}" in capsys.readouterr().out
    with open(path, encoding="utf-8") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for name in ("newmark_predictor", "effective_rhs", "pcg_solve",
                 "newmark_update", "pcg_matvec", "pcg_precondition"):
        assert name in names, name
    assert not profiling.tracing()


def test_scopes_are_no_ops_outside_a_trace(tmp_path):
    """The ranges open inside profiling.trace only: a profiler the caller
    opens records no range (its busy share would count them twice)."""
    from torch.profiler import ProfilerActivity, profile

    assert not profiling.tracing()
    assert profiling.scope("pcg_matvec") is profiling.scope("pcg_solve")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert not profiling.tracing()
        with profiling.scope("mg_level0"):
            torch.ones(4).sum()
    assert not any(e.key == "mg_level0" for e in prof.key_averages())
    with profiling.trace(str(tmp_path), "cpu") as info:
        assert profiling.tracing()
        with profiling.scope("mg_level0"):
            torch.ones(4).sum()
    assert not profiling.tracing()
    with open(info["path"], encoding="utf-8") as f:
        assert "mg_level0" in {e.get("name") for e in json.load(f)["traceEvents"]}
