"""Scenario runner: scenario -> model -> Newmark loop.

Port of :mod:`civiwave_tpu.runner`.  Two routes, as in the reference:

* the structured route, for ``synthetic://box`` hex scenarios with one
  material or with ``box_regions`` that place several (per-cell lam, mu
  and rho: G3 and the per-node block-Jacobi), and loads/fixes on the
  box's axis planes::

      load_config -> try_build_structured -> NewmarkStepper -> per-frame step

* the general gather path, for every other scenario (Gmsh files, tet or
  mixed meshes, several materials without ``box_regions``, point
  loads)::

      load_config -> load mesh -> preprocess.run -> build_packed_model
      -> NewmarkStepper -> per-frame step (curve loads re-assembled)

``build_simulation`` takes a scenario YAML path or an already-parsed
:class:`~civiwave_tpu_torch.config.schema.Config` (which needs no pyyaml),
the torch device to run on and an optional output root (VTU frames and the
probe CSV, written every frame by ``Simulation.run``).  Absorbing faces run
on both routes, and ``precision.vectors: fp64`` on either device.
:func:`run_static` is the static mode (BASELINE config #1): one PCG solve
of K u = f to the scenario's pause tolerance, exposed through the
stepper's state and written as VTU frame 0.  A stepping run can save
checkpoints (``utils/checkpoint.py``) every ``--checkpoint-every`` frames
and after its last, resume from the latest with ``--resume``, and write a
torch.profiler trace with ``--profile DIR``.

The trace (``utils/profiling.py``) holds the reference's named ranges and
the port's spans: ``frame`` around each frame of :meth:`Simulation.run`,
inside it ``load_update`` (the curve loads re-evaluated and set),
``pc_build`` (the preconditioner, when dt changes), the stepper's phases,
``telemetry_read`` (the frame's one read of the solver's scalars),
``output_frame`` and ``checkpoint_save``; in each PCG iteration
``pcg_matvec`` / ``pcg_pc_matvec_dots``, ``pcg_dots``, ``pcg_scalars``,
``pcg_vector_update`` (the axpys, the p/s update) and ``pcg_host_sync``
(the flag read, the branching on it and, in the classic loop, the p
update it decides, from the sync to the device's next launch); each
launch of the kernel library is an operator range named by its C entry,
so the ranges' device time holds the kernels.  ``--telemetry-json FILE`` writes one object per
frame (``StepTelemetry``) with ``host_syncs``, the points in the frame
where the host waited for the device (``utils.profiling.host_syncs``:
the solver's flag and telemetry reads, the general path's load upload,
output's and checkpoints' copies), and ``host_start_ns`` /
``host_end_ns``, the frame's start and end as ``time.time_ns()``: the
clock of the trace's events, so frame k of the JSON is the ``frame``
range that starts within its stamps (a Chrome trace's ``ts`` is
microseconds after its ``baseTimeNanoseconds``).  ``build_simulation``
records the general path's ``preprocess`` and ``pack`` host seconds, the
structured route's ``materials`` (the per-cell fields of ``box_regions``),
and the first frame its own, in ``utils.profiling.phases`` (read by the
benchmark); the first frame's object of ``--telemetry-json`` carries the
cells of each material (``Simulation.material_cells``), the layout the run
ran.

Usage::

    python -m civiwave_tpu_torch.runner scenario.yaml --frames 100 --output out/
    python -m civiwave_tpu_torch.runner scenario.yaml --static --output out/
    python -m civiwave_tpu_torch.runner scenario.yaml --frames 100 \
        --checkpoint-dir ck/ --checkpoint-every 50 --resume --profile trace/
    civiwave-tpu-torch scenario.yaml --frames 100 --device cuda
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .config.loader import load_config_from_file
from .config.schema import Config
from .mesh import pack, preprocess
from .mesh.gmsh import load_gmsh_file
from .mesh.model import Mesh
from .mesh.structured_config import (
    BOX_PREFIX,
    StructuredForceSchedule,
    parse_box_spec,
    try_build_structured,
)
from .physics import loads as loads_mod
from .physics import materials
from .solver.stepper import NewmarkStepper, StepTelemetry
from .utils import profiling
from .utils.errors import CwfError


@dataclass
class Simulation:
    """A fully-wired scenario ready to step.

    ``model`` is a :class:`~civiwave_tpu_torch.mesh.structured.
    StructuredModel` (with its ``force_schedule``) or a general
    :class:`~civiwave_tpu_torch.mesh.pack.PackedModel` (with the host
    ``mesh`` and ``preprocess`` its curve loads are assembled from; the
    structured route builds them only on demand, :meth:`ensure_host_mesh`).
    ``output`` is a ``post.output`` manager or None.
    """

    config: Config
    model: object
    stepper: NewmarkStepper
    force_schedule: Optional[StructuredForceSchedule] = None
    mesh: Optional[Mesh] = None
    preprocess: Optional[preprocess.PreprocessOutputs] = None
    output: Optional[object] = None
    _scenario_path: str = ""
    _first_frame: bool = True  # the next frame is the first this one runs

    @property
    def structured(self) -> bool:
        """Whether the scenario runs on the structured route."""
        return self.force_schedule is not None

    @property
    def material_cells(self) -> Dict[str, int]:
        """The cells (the general path: the elements) of each material the
        model holds, by name: the layout it runs."""
        if self.structured:
            return dict(self.model.material_cells)
        counts = np.bincount(self.preprocess.element_material_index,
                             minlength=len(self.config.materials))
        return {m.name: int(c) for m, c in zip(self.config.materials, counts) if c}

    def ensure_host_mesh(self) -> None:
        """Build the host mesh and preprocess on demand (the structured
        route skips them unless a consumer asks)."""
        if self.mesh is None:
            self.mesh = _load_mesh(self.config, self._scenario_path)
        if self.preprocess is None:
            self.preprocess = preprocess.run(self.mesh, self.config)

    def run(
        self, frames: int, paused_mode: bool = False, verbose: bool = False,
        checkpoint_manager=None, checkpoint_every: int = 50,
    ) -> List[StepTelemetry]:
        """Advance ``frames`` steps, re-evaluating time-curve loads and
        writing outputs per frame (the VTU writer is drained at the
        end).  With a ``checkpoint_manager`` the state is saved after
        every frame ``frame > 0`` with ``frame % checkpoint_every == 0``
        (the write runs on the manager's thread; 0 saves none).  Each
        frame is the range ``frame`` (its parts ``load_update``,
        ``output_frame``, ``checkpoint_save``) and stamps its telemetry's
        ``host_syncs``, ``host_start_ns`` and ``host_end_ns``; the first
        frame this simulation runs is the set-up phase ``first_frame``
        (``utils.profiling.phases``, ended by a device sync)."""
        loads = self.config.loads
        has_curves = any(t.scale_curve for t in loads.tractions) or any(
            p.scale_curve for p in loads.points
        )
        telemetries: List[StepTelemetry] = []
        t = self.stepper.accumulated_time
        start_frame = self.stepper.frame_index
        for frame in range(start_frame, start_frame + frames):
            syncs = profiling.host_syncs
            start_ns = time.time_ns()
            first = (profiling.phase("first_frame", self.model.device)
                     if self._first_frame else contextlib.nullcontext())
            self._first_frame = False
            with first, profiling.scope("frame"):
                if has_curves and frame > 0:
                    with profiling.scope("load_update"):
                        self.stepper.set_external_force(self._force_at(t))
                telemetry = self.stepper.step(t, paused_mode=paused_mode)
                t = self.stepper.accumulated_time
                if self.output is not None:
                    with profiling.scope("output_frame"):
                        self.output.handle_from_stepper(
                            telemetry.simulation_time, frame, self.stepper
                        )
                if (
                    checkpoint_manager is not None
                    and checkpoint_every > 0
                    and frame > 0
                    and frame % checkpoint_every == 0
                ):
                    with profiling.scope("checkpoint_save"):
                        self.stepper.save_checkpoint(checkpoint_manager)
            telemetry.host_end_ns = time.time_ns()
            telemetry.host_start_ns = start_ns
            telemetry.host_syncs = profiling.host_syncs - syncs
            telemetries.append(telemetry)
            if verbose:
                print(
                    f"frame {frame:5d} t={telemetry.simulation_time:.6f}s "
                    f"dt={telemetry.time_step:.2e} "
                    f"iters={telemetry.pcg_iterations} "
                    f"res={telemetry.pcg_residual_norm:.3e} "
                    f"conv={telemetry.pcg_converged}"
                )
        if self.output is not None:
            self.output.flush()
        return telemetries

    def _force_at(self, t: float) -> torch.Tensor:
        """External force at time ``t`` in the model's vector layout."""
        if self.force_schedule is not None:
            return self.force_schedule.at_time(self.config.curves, t)
        load = loads_mod.assemble_load_vector(
            self.mesh, self.config, self.preprocess, t
        )
        # from_nodal handles padding AND any RCM renumbering of the pack; a
        # shard keeps its own rows
        return self.model.own_rows(self.model.from_nodal(pack.clamp_to_f32(load)))


def _load_mesh(cfg: Config, scenario_path: str) -> Mesh:
    """Resolve the mesh: a Gmsh file (a relative path is tried against the
    working directory, then against the scenario file's directory), or
    the synthetic box scheme ``synthetic://box/nx,ny,nz[,tet|hex][,spacing]``
    with the scenario's ``box_regions`` as volume groups."""
    mesh_path = cfg.mesh_path
    if mesh_path.startswith(BOX_PREFIX):
        from .utils.synthetic import box_mesh

        nx, ny, nz, hex_elements, spacing = parse_box_spec(mesh_path)
        refs = (
            list(cfg.absorbing)
            + [t.group for t in cfg.loads.tractions]
            + [f.group for f in cfg.dirichlet]
        )
        return box_mesh(
            nx, ny, nz, hex_elements=hex_elements, spacing=spacing,
            # the six SIDE_* face groups whenever the scenario names one
            side_groups=any(g.startswith("SIDE_") for g in refs),
            regions=cfg.box_regions,
        )
    if not os.path.isabs(mesh_path):
        candidate = os.path.join(os.getcwd(), mesh_path)
        if not os.path.isfile(candidate):
            alt = os.path.join(os.path.dirname(scenario_path), mesh_path)
            candidate = alt if os.path.isfile(alt) else candidate
        mesh_path = candidate
    return load_gmsh_file(mesh_path)


def build_simulation(
    scenario: Union[str, Config], device="cuda",
    output_root: Optional[str] = None, *, pad_x_multiple: int = 1,
    pad_y_multiple: int = 1, pad_nodes: int = 8,
) -> Simulation:
    """Wire the structured route or the general gather path from a
    scenario path or a parsed Config, with every tensor on ``device``.
    Relative Gmsh paths of a parsed Config resolve against the working
    directory.  With ``output_root`` the simulation writes VTU frames and
    probe rows there (the structured route on the device, the general path
    from the host mesh).  On the structured route the pad multiples add
    dead +X planes and +Y rows so the grid divides an ``(npx, npy)`` shard
    group; on the general path the node count is padded to a multiple of
    ``pad_nodes`` (``8 * n`` for an n-rank group, as the reference packs)
    so it divides the group (``parallel.sharding.shard_simulation``, which
    keeps the output: rank 0 writes it)."""
    profiling.phases.clear()
    if isinstance(scenario, Config):
        cfg, scenario_path = scenario, ""
    else:
        cfg, scenario_path = load_config_from_file(scenario), scenario
    rayleigh = materials.compute_rayleigh(cfg.damping)
    routed = try_build_structured(
        cfg, pad_x_multiple=pad_x_multiple, pad_y_multiple=pad_y_multiple,
        device=device,
    )
    mesh = pre = schedule = None
    if routed is not None:
        model, schedule = routed
        force = schedule.at_time(cfg.curves, 0.0)
        print(
            f"path: structured route ({model.nx}x{model.ny}x{model.nz} grid, "
            f"{model.dof_count:,} DOF, device {model.device})",
            file=sys.stderr,
        )
    else:
        if cfg.solver.preconditioner == "multigrid":
            # as the reference: geometric MG needs the structured route's
            # uniform grid; the general path solves with block-Jacobi
            print(
                "note: solver.preconditioner 'multigrid' requires the "
                "structured route; this scenario takes the general path "
                "with block_jacobi",
                file=sys.stderr,
            )
        mats = [materials.make_properties(m) for m in cfg.materials]
        mesh = _load_mesh(cfg, scenario_path)
        with profiling.phase("preprocess"):
            pre = preprocess.run(mesh, cfg)
        with profiling.phase("pack", device):
            model, _state, force = pack.build_packed_model(
                mesh, pre, cfg, mats, pad_nodes=pad_nodes, device=device
            )
        print(
            f"path: general gather path ({mesh.element_count:,} elements, "
            f"{model.dof_count:,} DOF, dual-CSR assembly, device {model.device})",
            file=sys.stderr,
        )
    stepper = NewmarkStepper(
        model, model.zero_state(), force,
        rayleigh, cfg.solver, cfg.time,
        reduction_precision=cfg.precision.reduction_precision,
        vector_precision=cfg.precision.vector_precision,
    )
    sim = Simulation(
        config=cfg, model=model, stepper=stepper, force_schedule=schedule,
        mesh=mesh, preprocess=pre, _scenario_path=scenario_path,
    )
    if output_root is not None:
        from .post import output as output_mod

        if sim.structured:
            # derived fields on the device and O(1) probes: no host mesh
            sim.output = output_mod.StructuredOutputManager(
                output_root, cfg.output, model
            )
        else:
            _, _, d_all = materials.material_tables(mats)
            sim.output = output_mod.OutputManager(
                output_root, cfg.output, sim.mesh, sim.preprocess, d_all
            )
    return sim


def run_static(sim: Simulation, variant: str = "auto") -> Tuple[torch.Tensor, dict]:
    """Static mode (BASELINE config #1): one PCG solve of K u = f to the
    scenario's pause tolerance from a cold start.  The solution becomes the
    stepper's state (u, zero v and a, ``warm_x = u``) and, with output,
    VTU frame 0 and probe rows.  Returns (u in the model's vector layout,
    the telemetry payload of ``--telemetry-json``: mode, iterations,
    residual_norm, rhs_norm, converged, tolerance, max_displacement,
    elapsed_seconds).  On a shard u is this rank's and every rank calls it
    (the payload's max|u| gathers the field).  ``variant`` is the PCG variant; 'auto' is what the
    CLI runs, as the reference does; 'pipelined' replaces its residual
    every ``solver.replace_every`` iterations of the scenario."""
    from .mesh.pack import SimState
    from .solver.static import solve_static

    cfg = sim.config
    tolerance = cfg.solver.pause_tolerance
    start = time.perf_counter()
    u, pcg = solve_static(
        sim.model,
        sim.stepper.external_force,
        tolerance=tolerance,
        max_iterations=cfg.solver.max_iterations,
        reduction_precision=cfg.precision.reduction_precision,
        vector_precision=cfg.precision.vector_precision,
        variant=variant,
        replace_every=cfg.solver.replace_every,
    )
    residual, rhs_norm = profiling.to_host(
        torch.stack([pcg.residual_norm, pcg.rhs_norm])).tolist()
    elapsed = time.perf_counter() - start
    u_all = u
    if getattr(sim.model, "shard_group", None) is not None:
        from .parallel.sharding import gather

        u_all = gather(sim.model, u)  # a collective: every rank calls it

    # the solution through the stepper, so both output managers read it
    zero = torch.zeros_like(u)
    sim.stepper.state = SimState(
        displacement=u, velocity=zero, acceleration=zero, warm_x=u
    )
    if sim.output is not None:
        sim.output.handle_from_stepper(0.0, 0, sim.stepper)
        sim.output.flush()
    return u, {
        "mode": "static",
        "iterations": int(pcg.iterations),
        "residual_norm": residual,
        "rhs_norm": rhs_norm,
        "converged": bool(pcg.converged),
        "tolerance": tolerance,
        "max_displacement": float(sim.model.to_nodal(u_all).abs().max()),
        "elapsed_seconds": elapsed,
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
        "--output", default=None, help="output root for VTU/probe files"
    )
    parser.add_argument(
        "--paused", action="store_true", help="use the pause-mode tolerance"
    )
    parser.add_argument(
        "--static",
        action="store_true",
        help="solve static equilibrium K u = f instead of time stepping "
        "(one PCG solve to the pause tolerance; writes VTU frame 0)",
    )
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument(
        "--telemetry-json",
        default=None,
        help="write per-frame telemetry to this JSON file",
    )
    parser.add_argument(
        "--checkpoint-dir",
        default=None,
        help="save checkpoints here (and resume from here with --resume)",
    )
    parser.add_argument(
        "--checkpoint-every",
        type=int,
        default=50,
        help="checkpoint cadence in frames (0 disables periodic saves)",
    )
    parser.add_argument(
        "--resume",
        action="store_true",
        help="resume from the latest checkpoint in --checkpoint-dir",
    )
    parser.add_argument(
        "--profile",
        default=None,
        help="write a torch.profiler trace (Chrome JSON) into this directory",
    )
    args = parser.parse_args(argv)

    try:
        return _run_cli(args)
    except (CwfError, NotImplementedError) as err:
        # one clean line for a CLI user, not a traceback
        print(f"error: {err}", file=sys.stderr)
        return 1


def _run_cli(args) -> int:
    sim = build_simulation(
        args.scenario, device=args.device, output_root=args.output
    )
    if args.static:
        return _run_static_cli(sim, args)

    manager = None
    if args.checkpoint_dir:
        from .utils.checkpoint import CheckpointManager

        manager = CheckpointManager(args.checkpoint_dir)
        if args.resume and manager.latest_step() is not None:
            frame = sim.stepper.restore_checkpoint(manager)
            print(f"resumed from checkpoint at frame {frame}")

    trace = (profiling.trace(args.profile, sim.model.device) if args.profile
             else contextlib.nullcontext())
    with trace as profiled:
        start = time.perf_counter()
        telemetries = sim.run(
            args.frames,
            paused_mode=args.paused,
            verbose=not args.quiet,
            checkpoint_manager=manager,
            checkpoint_every=args.checkpoint_every,
        )
        elapsed = time.perf_counter() - start
    if args.profile:
        print(f"profile: {profiled['path']}")
    if manager is not None:
        sim.stepper.save_checkpoint(manager, wait=True)
        manager.close()

    converged = sum(1 for t in telemetries if t.pcg_converged)
    print(
        f"ran {len(telemetries)} frames in {elapsed:.3f}s "
        f"({len(telemetries) / max(elapsed, 1e-9):.1f} steps/s), "
        f"{converged}/{len(telemetries)} converged, "
        f"final t={sim.stepper.accumulated_time:.6f}s"
    )
    if args.telemetry_json:
        with open(args.telemetry_json, "w", encoding="utf-8") as f:
            frames = [asdict(t) for t in telemetries]
            if frames:  # the layout, once: on the first frame's object
                frames[0]["material_cells"] = sim.material_cells
            json.dump(frames, f, indent=2)
    return 0


def _run_static_cli(sim: Simulation, args) -> int:
    """``--static``: :func:`run_static`, its line on stdout and its payload
    in ``--telemetry-json``; exit 1 when the solve did not converge."""
    _, payload = run_static(sim)
    print(
        f"static solve: {payload['iterations']} PCG iterations to "
        f"tol {payload['tolerance']:g} in {payload['elapsed_seconds']:.3f}s, "
        f"residual {payload['residual_norm']:.3e}, "
        f"converged={payload['converged']}, "
        f"max |u| = {payload['max_displacement']:.6e} m"
    )
    if args.telemetry_json:
        with open(args.telemetry_json, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2)
    return 0 if payload["converged"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
