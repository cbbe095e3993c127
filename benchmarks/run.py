"""The benchmark of ``civiwave_tpu_torch``: one cell, one run.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is a configuration (``benchmarks/configs``) under a traffic mix
(``benchmarks/traffic``), as ``BENCHMARK.json`` pairs them.  A run builds
the scenario from the seed, wires it with the program's
``build_simulation``, warms up for the mix's frames, then calls
``Simulation.run`` one frame at a time, each ended by a device sync, until
``--seconds`` have passed (the last frame is whole).  With ``--trace 1``
the frames after the checked ones run under torch.profiler with the
program's named ranges open, for at most ``TRACE_SECONDS``, and the line
carries the per-layer metrics instead of the end-to-end ones.  A cell
that reports ``device_ms_per_step`` runs its whole plain window under a
profiler of the device alone (the host's loop is not timed there).

Once the window has closed, the program's answers of the first frame and
of a few consecutive window frames drawn from the seed (how many: the
cell's limits file) are judged by the plain reference in
``benchmarks/reference`` (and, with output, the first one's probe
rows).  The last line of standard output is one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error and
the line's last key.  Exit codes: 0 with a result, 1 on a fault
of the run, 2 on bad arguments, 3 without the card(s) the cell asks for.
"""

from __future__ import annotations

import time

_T0 = time.monotonic()  # process start, before the heavy imports

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TRACE_SECONDS = 6.0  # the traced part of a --trace 1 window, whole frames
# top-level module names that may not be loaded in the measuring process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "civiwave_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN_MODULES``, compared whole."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN_MODULES})


def set_cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout (the program's own
    kernel library is built in ``civiwave_tpu_torch/_build``)."""
    cache = ROOT / "benchmarks" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


class Capture:
    """Host copies of the state (u, v, a) at ``count`` points of a run, into
    buffers made during set-up (pinned on a card)."""

    def __init__(self, state, count: int, device):
        pin = device.type == "cuda"
        self.states = [[torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                        for t in _kinematics(state)] for _ in range(count)]

    def take(self, slot: int, state) -> None:
        for buf, t in zip(self.states[slot], _kinematics(state)):
            buf.copy_(t)


def _kinematics(state):
    return state.displacement, state.velocity, state.acceleration


def _frame(sim, sync):
    telemetry = sim.run(1)
    sync()
    return telemetry[0]


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float,
             mesh_path: str | None = None, log=sys.stderr, control_dtype=None) -> dict:
    """One run of ``cell``; returns the result object.  ``mesh_path``
    replaces the configuration's mesh (the tests' small sizes);
    ``control_dtype`` judges the control in the program's place
    (``benchmarks/control.py``), never in a run of the benchmark."""
    from civiwave_tpu_torch.config.loader import parse_config_node
    from civiwave_tpu_torch.runner import build_simulation
    from civiwave_tpu_torch.utils import profiling

    from benchmarks.harness import check, trace as tracing
    from benchmarks.harness.cells import metric_reader
    from benchmarks.harness.scenario import scenario_node
    from benchmarks.harness.traffic import generate
    from benchmarks.reference.mesh import parse_box

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    traffic = generate(cell.traffic, seed)
    node = scenario_node(cell.config, traffic, mesh_path)
    out_dir = (tempfile.mkdtemp(prefix="civiwave_bench_out_")
               if traffic.output is not None else None)
    try:
        cfg = parse_config_node(node)
        start = time.perf_counter()
        sim = build_simulation(cfg, device=device, output_root=out_dir)
        sync()
        build_s = time.perf_counter() - start
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)

        # warm-up: frame 0 (checked from rest), the mix's frames with the
        # output detached, then its output frames with it attached
        output, sim.output = sim.output, None
        checks = int(cell.limits["frames_checked"])
        capture = Capture(sim.stepper.state, checks + 2, device)
        first = _frame(sim, sync)
        capture.take(0, sim.stepper.state)
        for _ in range(traffic.warmup_frames - 1):
            _frame(sim, sync)
        sim.output = output
        warm = max(1, traffic.output_warmup_frames) if output else 8
        start = time.perf_counter()
        for _ in range(warm):
            _frame(sim, sync)
        frame_s = (time.perf_counter() - start) / warm
        window_first = sim.stepper.frame_index
        # the checked frames of the window: ``checks`` in a row from one
        # drawn from the seed among the frames of its first half (the
        # first two when traced)
        span = max(1, int(0.5 * seconds / frame_s))
        checked = int(traffic.rng.integers(min(span, 2) if trace else span))
        last = checked + checks - 1
        setup_s = time.monotonic() - t0
        # the measurement's own start (the profiler's) is neither the
        # program's set-up nor its window
        device_window = None
        if cuda and not trace and any(m["name"] == "device_ms_per_step"
                                      for m in cell.end_to_end):
            device_window = tracing.profile(device, host=False)
            device_window.__enter__()

        frame_ms, telemetry, traced = [], [], []
        prof = summary = None
        window_start = time.perf_counter()
        trace_start = None
        while True:
            j = len(frame_ms)
            if j == checked:
                capture.take(1, sim.stepper.state)
            start = time.perf_counter()
            tel = _frame(sim, sync)
            frame_ms.append((time.perf_counter() - start) * 1e3)
            telemetry.append(tel)
            if trace_start is not None:
                traced.append(tel)
            if checked <= j <= last:
                capture.take(j - checked + 2, sim.stepper.state)
                if j == last and trace:
                    prof = tracing.profile(device)
                    prof.__enter__()
                    ranges = tracing.ProgramRanges(profiling).__enter__()
                    trace_start = time.perf_counter()
            now = time.perf_counter()
            if trace_start is not None and now - trace_start >= min(seconds, TRACE_SECONDS):
                break
            if not trace and now - window_start >= seconds and j >= last:
                break
        window_s = time.perf_counter() - window_start
        device_busy_s = None
        if device_window is not None:
            device_window.__exit__(None, None, None)
            device_busy_s = tracing.device_busy_s(device_window)
            device_window = None
        if prof is not None:
            sync()
            traced_s = time.perf_counter() - trace_start
            ranges.__exit__(None, None, None)
            prof.__exit__(None, None, None)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if sim.stepper.frame_index > traffic.frames:
            print(f"error: the window ran past the mix's curve ({traffic.frames} "
                  "frames); the mix needs a longer curve", file=log)
            return None
        loaded = forbidden_modules()
        if loaded:
            print(f"error: the measuring process loaded {', '.join(loaded)}", file=log)
            return None
        if prof is not None:
            summary = tracing.summarize(prof, traced_s)
            prof = None

        # the program's answers, as nodal rows in mesh order: the first
        # frame from rest, and each checked frame of the window from the
        # state before it
        model = sim.model
        states = [[model.to_nodal(b.to(device)).to("cpu", torch.float64) for b in slot]
                  for slot in capture.states]
        answers = {"start": (None, states[0], 0)}
        for i in range(checks):
            answers[f"w{i}"] = (states[i + 1], states[i + 2], window_first + checked + i)
        # the program's own relative residual at each checked frame (its
        # solver's stopping measure), printed beside the reference's
        own = [first] + telemetry[checked:last + 1]
        own_residual = [t.pcg_residual_norm / t.pcg_rhs_norm if t.pcg_rhs_norm > 0
                        else 0.0 for t in own]
        probe_rows = None
        if output is not None:
            output.flush()
            probe_rows = check.read_probe_rows(
                output.probe_logger.path, window_first + checked)
        window_frames = len(frame_ms)
        ctx = SimpleNamespace(
            build_s=build_s, telemetry=traced, trace=summary, box=parse_box(node["mesh"]["path"]), frames=len(traced))
        del sim, model, output, capture
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        numbers = check.judge(node, traffic, answers, probe_rows, device, control_dtype,
                              config=cell.config_name)
    finally:
        if out_dir is not None:
            shutil.rmtree(out_dir, ignore_errors=True)

    correct, compared = check.compare(numbers, cell.limits)
    failed = sum(1 for t in (traced if trace else telemetry)
                 if not t.pcg_converged or t.pcg_breakdown)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        attempted = len(traced)
    else:
        values = dict(
            steps_per_s=window_frames / window_s,
            step_ms_p95=float(np.percentile(frame_ms, 95.0)),
            device_ms_per_step=(None if device_busy_s is None
                                else 1e3 * device_busy_s / window_frames),
            peak_mem_gib=peak / 2**30,
            setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if values[m["name"]] is not None}
        attempted = window_frames
    result = {
        "correct": correct, "attempted": attempted, "failed": failed,
        "metrics": metrics,
        "device": device_record(device, cell.chips, peak),
    }
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.wall_s)
        result["breakdown"] = {"device_ops": summary.device_ops(),
                               "idle_gaps": summary.idle_gaps}
    result["check"] = compared
    print(f"first frame: {first.pcg_iterations} PCG iterations; window: "
          f"{window_frames} frames in {window_s:.3f} s, checked frame "
          f"{window_first + checked}", file=log)
    for label, value in zip(answers, own_residual):
        print(f"program's own residual {label} {value:.6e}", file=log)
    for name, entry in compared.items():
        print(f"check {name} {entry['value']:.6e} limit {entry['limit']:.6e}", file=log)
    return result


def device_record(device, chips: int, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmarks.harness.cells import resolve

    try:
        cell = resolve(args.workload)
    except (KeyError, FileNotFoundError) as err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "available", file=sys.stderr)
        return 3
    try:
        import civiwave_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"error: the program under test is missing: {err}", file=sys.stderr)
        return 1
    set_cache_dirs()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), _T0)
    if result is None:
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
