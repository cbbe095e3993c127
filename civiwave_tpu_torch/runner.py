"""Scenario runner: scenario -> structured model -> Newmark loop.

Port of :mod:`civiwave_tpu.runner` for the structured route:

    load_config -> try_build_structured -> NewmarkStepper -> per-frame step

``build_simulation`` takes a scenario YAML path or an already-parsed
:class:`~civiwave_tpu_torch.config.schema.Config` (which needs no pyyaml)
and the torch device to run on.  A scenario the structured route does not
take (Gmsh meshes, tets, several materials, point loads) raises: the
general gather path waits for ROADMAP A6.

Usage::

    python -m civiwave_tpu_torch.runner scenario.yaml --frames 100
    civiwave-tpu-torch scenario.yaml --frames 100 --device cuda
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import asdict, dataclass
from typing import List, Optional, Union

from .config.loader import load_config_from_file
from .config.schema import Config
from .mesh.structured import StructuredModel
from .mesh.structured_config import StructuredForceSchedule, try_build_structured
from .physics import materials
from .solver.stepper import NewmarkStepper, StepTelemetry
from .utils.errors import CwfError


@dataclass
class Simulation:
    """A fully-wired structured scenario ready to step."""

    config: Config
    model: StructuredModel
    stepper: NewmarkStepper
    force_schedule: StructuredForceSchedule

    def run(
        self, frames: int, paused_mode: bool = False, verbose: bool = False
    ) -> List[StepTelemetry]:
        """Advance ``frames`` steps, re-evaluating time-curve loads per
        frame."""
        telemetries: List[StepTelemetry] = []
        t = self.stepper.accumulated_time
        start_frame = self.stepper.frame_index
        for frame in range(start_frame, start_frame + frames):
            if self.force_schedule.has_curves and frame > 0:
                self.stepper.set_external_force(
                    self.force_schedule.at_time(self.config.curves, t)
                )
            telemetry = self.stepper.step(t, paused_mode=paused_mode)
            telemetries.append(telemetry)
            t = self.stepper.accumulated_time
            if verbose:
                print(
                    f"frame {frame:5d} t={telemetry.simulation_time:.6f}s "
                    f"dt={telemetry.time_step:.2e} "
                    f"iters={telemetry.pcg_iterations} "
                    f"res={telemetry.pcg_residual_norm:.3e} "
                    f"conv={telemetry.pcg_converged}"
                )
        return telemetries


def build_simulation(
    scenario: Union[str, Config], device="cuda"
) -> Simulation:
    """Wire the structured route from a scenario path or a parsed Config,
    with every tensor on ``device``."""
    cfg = (
        scenario if isinstance(scenario, Config)
        else load_config_from_file(scenario)
    )
    rayleigh = materials.compute_rayleigh(cfg.damping)
    routed = try_build_structured(cfg, device=device)
    if routed is None:
        raise NotImplementedError(
            f"scenario mesh {cfg.mesh_path!r} needs the general gather path, "
            "which is not ported yet (ROADMAP A6)"
        )
    model, schedule = routed
    print(
        f"path: structured route ({model.nx}x{model.ny}x{model.nz} grid, "
        f"{model.dof_count:,} DOF, device {model.device})",
        file=sys.stderr,
    )
    stepper = NewmarkStepper(
        model, model.zero_state(), schedule.at_time(cfg.curves, 0.0),
        rayleigh, cfg.solver, cfg.time,
        reduction_precision=cfg.precision.reduction_precision,
        vector_precision=cfg.precision.vector_precision,
    )
    return Simulation(
        config=cfg, model=model, stepper=stepper, force_schedule=schedule
    )


# CLI options of the reference runner whose subsystems are not ported yet
_UNPORTED_OPTIONS = {
    "output": "--output (VTU/probe output, ROADMAP A5)",
    "static": "--static (static solve, ROADMAP A8)",
    "checkpoint_dir": "--checkpoint-dir (checkpoints, ROADMAP A10)",
    "profile": "--profile (device tracing, ROADMAP A14)",
}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="civiwave-tpu-torch",
        description="Run a CiviWave scenario with PyTorch (CUDA or CPU).",
    )
    parser.add_argument("scenario", help="path to the scenario YAML")
    parser.add_argument("--frames", type=int, default=10, help="frames to run")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; cpu runs the plain "
        "PyTorch versions of the kernels)",
    )
    parser.add_argument(
        "--paused", action="store_true", help="use the pause-mode tolerance"
    )
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument(
        "--telemetry-json",
        default=None,
        help="write per-frame telemetry to this JSON file",
    )
    parser.add_argument("--output", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--static", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--checkpoint-dir", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--profile", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    for name, what in _UNPORTED_OPTIONS.items():
        if getattr(args, name):
            print(f"error: {what} is not ported yet", file=sys.stderr)
            return 1
    try:
        return _run_cli(args)
    except (CwfError, NotImplementedError) as err:
        # one clean line for a CLI user, not a traceback
        print(f"error: {err}", file=sys.stderr)
        return 1


def _run_cli(args) -> int:
    sim = build_simulation(args.scenario, device=args.device)
    start = time.perf_counter()
    telemetries = sim.run(
        args.frames, paused_mode=args.paused, verbose=not args.quiet
    )
    elapsed = time.perf_counter() - start
    converged = sum(1 for t in telemetries if t.pcg_converged)
    print(
        f"ran {len(telemetries)} frames in {elapsed:.3f}s "
        f"({len(telemetries) / max(elapsed, 1e-9):.1f} steps/s), "
        f"{converged}/{len(telemetries)} converged, "
        f"final t={sim.stepper.accumulated_time:.6f}s"
    )
    if args.telemetry_json:
        with open(args.telemetry_json, "w", encoding="utf-8") as f:
            json.dump([asdict(t) for t in telemetries], f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
