"""The port's spans, its host-sync counter, its frame stamps and its set-up
phases (``civiwave_tpu_torch/utils/profiling.py``), and the benchmark's
readers of them.  CPU, small boxes; the one ``cuda`` test (a range holds
the device time of the kernel library's launches inside it) skips here.

    python -m pytest -q tests/test_torch_tracing.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from civiwave_tpu_torch.runner import build_simulation
from civiwave_tpu_torch.utils import profiling
from civiwave_tpu_torch.utils.synthetic import cantilever_config

ROOT = Path(__file__).resolve().parents[1]
BOXES = {"structured": "synthetic://box/6,3,3", "tet": "synthetic://box/6,3,3,tet"}
NEW_SPANS = ("frame", "load_update", "pc_build", "telemetry_read", "output_frame",
             "checkpoint_save", "pcg_host_sync", "pcg_dots", "pcg_scalars",
             "pcg_vector_update")
# the PCG iteration's ranges of each variant (one of the reference's, the
# rest the program's own)
PCG_SPANS = {
    "classic": {"pcg_solve", "pcg_matvec", "pcg_dots", "pcg_vector_update",
                "pcg_precondition", "pcg_host_sync"},
    "fused": {"pcg_solve", "pcg_vector_update", "pcg_pc_matvec_dots",
              "pcg_scalars", "pcg_host_sync"},
}


def _sim(box: str, variant: str = "classic", output_root=None, **extra):
    """A cantilever box under a load ramped from zero (frame 0 from rest
    stops at 0 iterations; every later frame re-assembles the load)."""
    cfg = cantilever_config(
        mesh={"path": BOXES[box]}, tol_runtime=2e-4,
        curves={"ramp": [[0.0, 0.0], [1.0, 1000.0]]},
        loads={"gravity": [0.0, 0.0, 0.0],
               "tractions": [{"group": "LOAD_FACE", "value": [0.0, 0.0, -1e6],
                              "scale_curve": "ramp"}]}, **extra)
    sim = build_simulation(cfg, device="cpu", output_root=output_root)
    sim.stepper.solver_variant = variant
    return sim


def _names(prof) -> set:
    return {e.name() for e in prof.profiler.kineto_results.events()}


@pytest.mark.parametrize("name", NEW_SPANS)
def test_spans_are_the_null_context_outside_a_trace(name):
    assert not profiling.tracing()
    assert profiling.scope(name) is profiling._NULL
    assert profiling.launch(name) is profiling._NULL


def test_own_profiler_records_no_span():
    """A caller's own profiler (the ranges closed) sees the operators of
    two frames and none of the program's spans."""
    sim = _sim("tet")
    sim.run(1)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run(2)
    names = _names(prof)
    assert any(n.startswith("aten::") for n in names)
    assert not names & (set(NEW_SPANS) | PCG_SPANS["classic"])


@pytest.mark.parametrize("box,variant", [("structured", "classic"),
                                         ("structured", "fused"),
                                         ("tet", "classic"), ("tet", "fused")])
def test_trace_records_the_spans(box, variant, tmp_path):
    sim = _sim(box, variant)
    sim.run(1)
    with profiling.trace(str(tmp_path), "cpu") as info:
        telemetry = sim.run(2)
    assert all(t.pcg_iterations > 0 for t in telemetry)
    names = _names(info["profiler"])
    assert {"frame", "load_update", "telemetry_read"} <= names
    assert PCG_SPANS[variant] <= names
    assert not profiling.tracing()


@pytest.mark.parametrize("box", sorted(BOXES))
@pytest.mark.parametrize("variant", ["classic", "fused"])
def test_host_syncs_per_frame(box, variant):
    """One per flag read (iterations + 1 in the classic and fused loops),
    one telemetry read, one pageable load upload on the general path after
    frame 0, and the first frame's closing sync; frame 0 from rest stops
    at 0 iterations.  The CPU counts the points where a card waits."""
    sim = _sim(box, variant)
    telemetry = sim.run(3)
    assert telemetry[0].pcg_iterations == 0
    assert all(t.pcg_iterations > 0 for t in telemetry[1:])
    for frame, t in enumerate(telemetry):
        upload = int(box == "tet" and frame > 0)
        first = int(frame == 0)
        assert t.host_syncs == t.pcg_iterations + 1 + 1 + upload + first


@pytest.mark.parametrize("box", sorted(BOXES))
def test_host_syncs_with_output_and_checkpoints(box, tmp_path):
    """Output's and checkpoints' host copies count where they are made.
    The general path copies u, v and a every frame.  The structured route
    copies its six derived fields, u, v and a (and once the rest
    positions) on a VTU frame, and every frame uploads its probes' cell
    indices and copies their samples and materials.  A checkpoint copies
    four vectors."""
    from civiwave_tpu_torch.utils.checkpoint import CheckpointManager

    sim = _sim(box, output_root=str(tmp_path / "out"),
               output={"vtu_stride": 2, "probes": [0, 5]})
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    telemetry = sim.run(4, checkpoint_manager=manager, checkpoint_every=2)
    manager.close()
    assert len(list((tmp_path / "out" / "vtu").iterdir())) == 2
    assert manager.steps() == [3]  # saved after frame 2, as its next index
    for frame, t in enumerate(telemetry):
        solver = t.pcg_iterations + 1 + 1 + int(frame == 0)
        if box == "tet":
            output = 3
            solver += int(frame > 0)  # the load's upload
        else:
            output = 3 + (6 + 3 + int(frame == 0)) * int(frame % 2 == 0)
        checkpoint = 4 * int(frame == 2)
        assert t.host_syncs == solver + output + checkpoint, frame


def test_launches_go_through_the_library_call():
    """Every wrapper launches through ``KernelLibrary.call`` (the device
    guard, the error check and ``profiling.launch``): no other module of
    ``ops/cuda`` calls an entry of the library itself."""
    cuda = ROOT / "civiwave_tpu_torch" / "ops" / "cuda"
    wrappers = [f for f in sorted(cuda.glob("*.py")) if f.name != "_build.py"]
    calls = [f.name for f in wrappers if ".call(" in f.read_text()]
    assert len(calls) == 11
    assert [f.name for f in wrappers if ".lib" in f.read_text()] == []


def test_frame_range_lies_within_its_stamps(tmp_path):
    """The stamps are on the clock of the profiler's events: each frame's
    ``frame`` range lies within [host_start_ns, host_end_ns] to 1 ms."""
    sim = _sim("tet")
    sim.run(1)
    with profiling.trace(str(tmp_path), "cpu") as info:
        telemetry = sim.run(3)
    frames = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in info["profiler"].profiler.kineto_results.events()
                    if e.name() == "frame")
    assert len(frames) == len(telemetry) == 3
    for (start, end), t in zip(frames, telemetry):
        assert t.host_start_ns < t.host_end_ns
        assert t.host_start_ns - 1_000_000 <= start <= end <= t.host_end_ns + 1_000_000


def test_phases_of_a_build():
    """A tet box's build records its preprocess and pack phases, whose sum
    is within the build's wall time, and its first frame its own; the next
    build clears them.  Each phase has the benchmark's reader."""
    start = time.perf_counter()
    sim = _sim("tet")
    wall = time.perf_counter() - start
    phases = dict(profiling.phases)
    assert set(phases) == {"preprocess", "pack"}
    assert all(v > 0 for v in phases.values())
    assert phases["preprocess"] + phases["pack"] <= wall
    sim.run(1)
    first = profiling.phases["first_frame"]
    assert first > 0
    sim.run(2)  # only the first frame is a phase
    assert profiling.phases["first_frame"] == first
    readers = "".join(f.read_text() for f in (ROOT / "benchmarks" / "metrics").glob("*.py"))
    assert all(f'phases", {{}}).get("{name}")' in readers for name in profiling.phases)
    _sim("structured")
    assert profiling.phases == {}


@pytest.mark.parametrize("cell,present,absent", [
    ("cantilever-255.sway", ("host_syncs_per_iter", "first_frame_s"), ()),
    ("tet-cantilever-66.sway", ("build_preprocess_s", "build_pack_s", "first_frame_s"),
     ("load_device_ms_per_step",)),
])
def test_readers_in_a_traced_small_run(cell, present, absent):
    """The new per-layer metrics of a traced run of each cell at its small
    size on the CPU; the device-time reader finds no device time there.
    The run has a process of its own: the benchmark refuses a process that
    has loaded jax, as this one has."""
    script = ("import json, sys; from benchmarks.tests.support import run_small; "
              f"print(json.dumps(run_small({cell!r}, 2**31 + 3, trace=True)))")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
    metrics = result["metrics"]
    for name in present:
        assert isinstance(metrics[name]["value"], float) and metrics[name]["value"] > 0
    for name in absent:
        assert name not in metrics
    if "host_syncs_per_iter" in present:
        # (iterations + 2) over iterations, the mix's frames at ~16
        assert 1.0 < metrics["host_syncs_per_iter"]["value"] < 1.5


@pytest.mark.cuda
def test_range_holds_the_kernel_library_launches(tmp_path):
    """A range around one apply_keff of a small tet model reads at least
    the device time of the K7 and G1 kernels launched inside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.autograd import DeviceType

    cfg = cantilever_config(mesh={"path": "synthetic://box/24,24,24,tet"})
    model = build_simulation(cfg, device="cuda").model
    x = torch.randn(model.vector_shape, device="cuda")
    for _ in range(3):
        model.apply_keff(x, 1.02, 4.0e6)
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path), "cuda") as info:
        with profiling.scope("apply_keff_range"):
            model.apply_keff(x, 1.02, 4.0e6)
    rows = info["profiler"].key_averages()
    host = {e.key: e for e in rows if e.device_type == DeviceType.CPU}
    kernels = sum(e.self_device_time_total for e in rows
                  if e.device_type != DeviceType.CPU
                  and ("element_forces_kernel" in e.key or "assemble_csr_kernel" in e.key))
    assert kernels > 0
    assert host["apply_keff_range"].device_time_total >= kernels
