"""Run a sharded simulation over several ranks.

The counterpart of the reference's ``examples/multichip_2d.py`` and of its
multi-device dry run::

    python -m civiwave_tpu_torch.parallel.launch --npx 2 --npy 2 \\
        --cells 15,7,6 --frames 5 [--device cpu] [--against-one-rank]

spawns ``npx * npy`` processes (one rank each; NCCL with one GPU per rank
on CUDA, the default; gloo with ``--device cpu``).  Each rank builds the
scenario with ``runner.build_simulation`` (``--scenario FILE.yaml``, or by
default the steel cantilever of ``utils.synthetic.cantilever_config`` on a
``synthetic://box/<cells>`` mesh) with ``pad_x_multiple=npx``,
``pad_y_multiple=npy`` and ``pad_nodes=8*npx``, shards it with
``parallel.sharding.shard_simulation`` and runs it frame by frame, curve
loads and adaptive dt included.  A scenario on the structured route (a
homogeneous hex box, absorbing faces included, e.g.
``examples/seismic_basin.yaml``) is cut into X-slabs (``--npy 1``) or
(X, Y) tiles (``--npy`` > 1); one on the general path (a Gmsh file such as
``examples/seismic_column_tet.yaml``, or ``--cells 40,8,8,tet``) into
node-row blocks over a 1-D group, with the banded halo exchange where its
plan holds.  After each frame every rank gathers the displacement and
acceleration (a collective).  Rank 0 prints each frame's PCG iterations,
``converged``, max|u| and step seconds (the step alone, after a device
sync), then steps/s and ms per PCG iteration over frames 2 onwards.
``--static`` solves K u = f once instead (``runner.run_static``) and
prints its line.  ``CIVIWAVE_HALO_OVERLAP=0`` and
``CIVIWAVE_GENERAL_HALO=0`` in the environment reach every rank.

``--output DIR`` writes the VTU frames and probe rows of the scenario's
``output`` settings, as the runner's ``--output``: every rank derives its
share and rank 0 writes the files an unsharded run writes.
``--checkpoint-dir DIR`` saves a checkpoint every ``--checkpoint-every``
frames (default 50; 0: the final save only) and after the run, and
``--resume`` first restores the latest one (none: frame 0), as the
runner's flags; rank 0 writes one file of the padded global model, which
the unsharded build of the same padding (and a group of another size
over the same padding) restores too.

``--profile DIR`` has every rank write a torch.profiler trace of frames 2
onwards (the per-frame gathers included) into DIR, as the runner's
``--profile``, and rank 0 print its ``utils.profiling.summary``.
``--out FILE.npz`` has rank 0 write each frame's gathered displacement and
acceleration, dt, iterations and the collective counts.
``--against-one-rank`` then runs the same frames on one rank with the PCG
variant the group ran ('auto' resolves differently on one rank of the
general path, as in the reference) and exits 1 unless the group's
iterations are within 1 of it and u and a within 2.5e-4 and 3e-3 of its
max|.| (a static solve: both converged and u within 2.5e-4); the
one-rank run writes no output and no checkpoint.  Several
processes meet at ``--init-method`` (default
``tcp://localhost:<a free port>``); a world of one needs none.  Ranks that
outlast ``--timeout`` seconds are killed.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import socket
import sys
import tempfile
import time

import numpy as np
import torch

U_TOL, A_TOL = 2.5e-4, 3e-3


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _scenario(args):
    """The scenario path, or the cantilever of ``--cells`` as a Config."""
    if args.scenario:
        return args.scenario
    from ..utils.synthetic import cantilever_config

    # a static solve runs to the pause tolerance (1e-8), as the CLI's
    return cantilever_config(
        tol_runtime=2e-4, max_iters=4000 if args.static else 120, dt=1e-3,
        adaptive=False, mesh={"path": "synthetic://box/" + args.cells},
    )


def run_rank(rank: int, args) -> None:
    """One rank: join the group, build, shard and step the scenario."""
    import torch.distributed as dist

    from ..runner import build_simulation
    from ..utils import profiling
    from . import collectives
    from .sharding import (
        close_shard_group,
        make_shard_group,
        make_shard_group_2d,
        shard_simulation,
    )

    torch.set_num_threads(1)
    world = args.npx * args.npy
    device = torch.device(args.device)
    if world > 1:  # a world of one starts from an in-memory store
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=args.init_method, rank=rank, world_size=world,
        )
    try:
        if args.npy > 1:
            group = make_shard_group_2d(args.npx, args.npy, device)
        else:
            group = make_shard_group(args.npx, device)
        sim = build_simulation(
            _scenario(args), device=group.device, output_root=args.output,
            pad_x_multiple=args.npx, pad_y_multiple=args.npy,
            pad_nodes=8 * world,
        )
        sim = shard_simulation(sim, group)
        manager = None
        if args.checkpoint_dir:
            from ..utils.checkpoint import CheckpointManager

            manager = CheckpointManager(args.checkpoint_dir)
            if args.resume and manager.latest_step() is not None:
                start = sim.stepper.restore_checkpoint(manager)
                if rank == 0:
                    print(f"resumed from checkpoint at frame {start}",
                          flush=True)
        if args.variant:
            sim.stepper.solver_variant = args.variant
        variant = sim.stepper.pcg_variant()

        def sync():
            if group.device.type == "cuda":
                torch.cuda.synchronize(group.device)

        collectives.reset_counts()
        if args.static:
            _static_rank(sim, variant, group, args)
            return
        sim.stepper.solver_variant = variant

        def frame(index):
            sync()
            t0 = time.perf_counter()
            [tel] = sim.run(1, checkpoint_manager=manager,
                            checkpoint_every=args.checkpoint_every)
            sync()
            seconds = time.perf_counter() - t0
            u = sim.stepper.displacement()  # gathers: every rank calls it
            a = sim.stepper.acceleration()
            if rank == 0:
                print(
                    f"frame {index}: {tel.pcg_iterations} PCG iters, "
                    f"converged={tel.pcg_converged}, "
                    f"|u|max={float(np.abs(u).max()):.3e} m, "
                    f"step {seconds:.4f} s",
                    flush=True,
                )
            return tel, seconds, u, a

        frames = [frame(0)] if args.frames else []
        trace = (profiling.trace(args.profile, group.device) if args.profile
                 else contextlib.nullcontext())
        with trace as profiled:
            frames += [frame(index) for index in range(1, args.frames)]
        if manager is not None:
            sim.stepper.save_checkpoint(manager, wait=True)
            manager.close()
        if rank == 0 and args.profile:
            summary = profiling.summary(profiled["profiler"],
                                        profiled["wall_ms"])
            print(f"profile (rank 0 of {world}, frames 2-{args.frames}): "
                  f"{profiled['path']}\nprofile summary: {summary}",
                  flush=True)
        iters = [t.pcg_iterations for t, _, _, _ in frames]
        steady = [s for _, s, _, _ in frames[1:]]
        if rank == 0 and steady and sum(iters[1:]):
            print(
                f"{world} rank(s), {'2-D' if group.two_d else '1-D'}: "
                f"{len(steady) / sum(steady):.4f} steps/s, "
                f"{sum(steady) / sum(iters[1:]) * 1e3:.4f} ms per PCG "
                f"iteration (frames 2-{len(frames)})",
                flush=True,
            )
        if rank == 0 and args.out:
            shapes = collectives.psum.shapes
            np.savez(
                args.out,
                variant=variant,
                iterations=np.array(iters),
                converged=np.array([t.pcg_converged for t, _, _, _ in frames]),
                time_step=np.array([t.time_step for t, _, _, _ in frames]),
                displacement=np.stack([u for _, _, u, _ in frames]),
                acceleration=np.stack([a for _, _, _, a in frames]),
                ppermute_calls=collectives.ppermute.calls,
                psum_calls=collectives.psum.calls,
                psum_f64_3=shapes[(torch.float64, (3,))],
                psum_f64_4=shapes[(torch.float64, (4,))],
                all_gather_calls=collectives.all_gather.calls,
            )
    finally:
        close_shard_group()


def _static_rank(sim, variant, group, args) -> None:
    """``--static`` on one rank: ``runner.run_static``, its line on rank 0
    and, with ``--out``, the gathered u."""
    from ..runner import run_static
    from . import collectives
    from .sharding import gather

    u, payload = run_static(sim, variant=variant)
    u = sim.model.to_nodal(gather(sim.model, u)).cpu().numpy()
    if group.rank != 0:
        return
    print(f"static solve ({variant}) over {group.size} rank(s): "
          f"{payload['iterations']} PCG iterations, converged="
          f"{payload['converged']}, {payload['elapsed_seconds']:.4f} s, "
          f"max |u| = {payload['max_displacement']:.6e} m", flush=True)
    if args.out:
        np.savez(
            args.out, variant=variant, static=True,
            iterations=np.array([payload["iterations"]]),
            converged=np.array([payload["converged"]]),
            displacement=u[None],
            ppermute_calls=collectives.ppermute.calls,
            psum_f64_3=collectives.psum.shapes[(torch.float64, (3,))],
            all_gather_calls=collectives.all_gather.calls,
        )


def _spawn(args) -> int:
    """Run every rank of ``args`` in a process of its own; 0 if all
    exit cleanly."""
    world = args.npx * args.npy
    if world > 1 and args.init_method is None:
        args = argparse.Namespace(**{**vars(args), "init_method":
                                     f"tcp://localhost:{_free_port()}"})
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run_rank, args=(rank, args))
             for rank in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + args.timeout
    try:
        while any(p.is_alive() for p in procs):
            if time.monotonic() > deadline:
                print(f"error: ranks still running after {args.timeout:g} s",
                      file=sys.stderr)
                return 1
            if any(p.exitcode not in (None, 0) for p in procs):
                break  # a rank failed: the others may wait for it forever
            time.sleep(0.05)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        print(f"error: rank exit codes {codes}", file=sys.stderr)
        return 1
    return 0


def compare(got, ref) -> bool:
    """Print and check the group's frames against the one-rank run's:
    iterations within 1 (BASELINE's stepping rule), every frame converged,
    u and a within U_TOL and A_TOL of max|ref|.  A static solve is held to
    convergence on both and u within U_TOL; its iterations are printed, not
    held: an f32 solve to 1e-8 ends at the rounding floor, where another
    order of the ghost-band sums moves the count by a few."""
    def rel(k):
        return float(np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max())

    static = "static" in got
    du = rel("displacement")
    da = 0.0 if static else rel("acceleration")
    ok = bool((static or np.abs(got["iterations"] - ref["iterations"]).max() <= 1)
              and got["converged"].all() and ref["converged"].all()
              and du <= U_TOL and da <= A_TOL)
    print(f"against one rank: iterations "
          f"{got['iterations'].tolist()} (one rank "
          f"{ref['iterations'].tolist()}); max diff / max|one rank| u "
          f"{du:.3e} (tol {U_TOL:g}), a {da:.3e} (tol {A_TOL:g}); ghost "
          f"exchanges {int(got['ppermute_calls'])}, f64 (3,) all-reduces "
          f"{int(got['psum_f64_3'])}, all-gathers "
          f"{int(got['all_gather_calls'])}; PCG {got['variant']}"
          f"{'' if ok else ' FAIL'}",
          flush=True)
    return ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m civiwave_tpu_torch.parallel.launch",
        description="Run a sharded simulation over npx*npy ranks.",
    )
    parser.add_argument("--npx", type=int, default=2)
    parser.add_argument("--npy", type=int, default=1)
    parser.add_argument("--scenario", default=None,
                        help="scenario YAML (default: the cantilever of "
                        "--cells)")
    parser.add_argument("--cells", default="15,7,6",
                        help="nx,ny,nz[,tet|hex] cells of the cantilever box "
                        "(tet: the general path)")
    parser.add_argument("--frames", type=int, default=5)
    parser.add_argument("--static", action="store_true",
                        help="solve K u = f once instead of stepping")
    parser.add_argument("--device", default="cuda",
                        help="cuda (NCCL, one GPU per rank) or cpu (gloo)")
    parser.add_argument("--init-method", default=None,
                        help="torch.distributed init method "
                        "(default tcp://localhost:<a free port>)")
    parser.add_argument("--timeout", type=float, default=600.0)
    parser.add_argument("--out", default=None,
                        help="rank 0 writes the frames to this .npz")
    parser.add_argument("--against-one-rank", action="store_true",
                        help="then run one rank and compare the frames")
    parser.add_argument("--output", default=None,
                        help="output root for VTU/probe files (rank 0 "
                        "writes them)")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="save checkpoints here (and resume from here "
                        "with --resume)")
    parser.add_argument("--checkpoint-every", type=int, default=50,
                        help="checkpoint cadence in frames (0 disables "
                        "periodic saves)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint in "
                        "--checkpoint-dir")
    parser.add_argument("--profile", default=None,
                        help="write each rank's torch.profiler trace of "
                        "frames 2 on into this directory; rank 0 prints "
                        "its summary")
    # the scenario's PCG variant; the one-rank rerun takes the group's
    parser.set_defaults(variant=None)
    args = parser.parse_args(argv)
    world = args.npx * args.npy
    if torch.device(args.device).type == "cuda" and (
        world > torch.cuda.device_count()
    ):
        print(f"error: {world} ranks need {world} GPUs, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    if not args.against_one_rank:
        return _spawn(args)
    with tempfile.TemporaryDirectory() as tmp:
        if args.out is None:
            args.out = os.path.join(tmp, "group.npz")
        if _spawn(args):
            return 1
        got = np.load(args.out)
        one = argparse.Namespace(**{**vars(args), "npx": 1, "npy": 1,
                                    "variant": str(got["variant"]),
                                    "out": os.path.join(tmp, "one.npz"),
                                    "output": None, "checkpoint_dir": None})
        print("== one rank", flush=True)
        if _spawn(one):
            return 1
        return 0 if compare(got, np.load(one.out)) else 1


if __name__ == "__main__":
    raise SystemExit(main())
