"""One rank of ``test_torch_sharded_output``: checkpoints, output, derived
fields and probes of a shard.

Run as a script, once per rank (torch and the port, no jax)::

    python tests/torch_sharded_output_support.py --rank R --npx 2 --npy 2 \\
        --route structured --init-method file:///.../store --out DIR

``--route`` is ``structured`` (the cantilever of :data:`CELLS` padded for
the group; ``--npy`` > 1 makes the group 2-D), ``hetero`` (the same grid
with per-cell materials, ``torch_sharded_support.hetero_cells``) or
``general`` (the tet box :data:`TET_CELLS` over a 1-D group).

Each rank builds the scenario with output under ``DIR/out``, shards it
(``shard_simulation``) and runs :data:`FRAMES` frames with a checkpoint
manager under ``DIR/ck`` saving every 2 frames.  The output manager is
called after each frame outside ``Simulation.run``, so the collectives it
makes are counted on their own.  Then a new build restores the checkpoint
of frame 2 and runs to the same end.  Rank 0 writes ``DIR/result.npz``:
per frame the gathered global u, v and a, the clock, and the output's
``ppermute`` and ``gather`` calls; whether the resumed run's four vectors,
dt, clock and frame equal the uninterrupted run's; on the structured
routes the gathered derived fields of the last state.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from civiwave_tpu_torch.parallel import collectives, sharding  # noqa: E402
from civiwave_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402
from civiwave_tpu_torch.utils.synthetic import cantilever_config  # noqa: E402

CELLS = (9, 4, 5)  # 10x5x6 nodes: 2 slabs of 5 planes, a dead +Y row on 2x2
TET_CELLS = (4, 2, 2)
FRAMES = 4
CHECKPOINT_EVERY = 2
# corner, a node on the slab cut (its window crosses it), one on the tile
# cut along Y, the far corner
PROBES = (0, 165, 138, 299)
TET_PROBES = (0, 22, 44)
FIELDS = ("displacement", "velocity", "acceleration", "warm_x")


def scenario(route: str):
    """The scenario's Config (a fixed dt; VTU every 2 frames)."""
    cells, probes = ((TET_CELLS, TET_PROBES) if route == "general"
                     else (CELLS, PROBES))
    tet = ",tet" if route == "general" else ""
    return cantilever_config(
        mesh={"path": "synthetic://box/" + ",".join(map(str, cells)) + tet},
        tol_runtime=2e-4, max_iters=200, dt=1e-3, adaptive=False,
        output={"vtu_stride": 2, "probes": list(probes)})


def build(route: str, npx: int, npy: int, output_root=None):
    """The unsharded simulation of ``route`` padded for an (npx, npy) group
    (``runner.build_simulation``; by API with per-cell materials on the
    heterogeneous route, as the reference's own case)."""
    from civiwave_tpu_torch.runner import Simulation, build_simulation

    cfg = scenario(route)
    pads = dict(pad_x_multiple=npx, pad_y_multiple=npy, pad_nodes=8 * npx)
    if route != "hetero":
        return build_simulation(cfg, "cpu", output_root, **pads)
    from civiwave_tpu_torch.mesh.structured import build_structured_model
    from civiwave_tpu_torch.mesh.structured_config import (
        StructuredForceSchedule,
    )
    from civiwave_tpu_torch.physics import materials
    from civiwave_tpu_torch.post.output import StructuredOutputManager
    from civiwave_tpu_torch.solver.stepper import NewmarkStepper
    from torch_sharded_support import hetero_cells

    mat = cfg.materials[0]
    lam, mu = hetero_cells(CELLS)
    model, force = build_structured_model(
        *CELLS, materials.make_properties(mat), mat.density,
        traction=(0.0, 0.0, -1.0e6), pad_x_multiple=npx, pad_y_multiple=npy,
        lam_grid=lam, mu_grid=mu, device="cpu")
    stepper = NewmarkStepper(model, model.zero_state(), force,
                             materials.compute_rayleigh(cfg.damping),
                             cfg.solver, cfg.time)
    output = (None if output_root is None else
              StructuredOutputManager(output_root, cfg.output, model))
    return Simulation(config=cfg, model=model, stepper=stepper,
                      force_schedule=StructuredForceSchedule(force, []),
                      output=output)


def gathered(sim, name):
    return sharding.gather(sim.model, getattr(sim.stepper.state, name)).numpy()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--npx", type=int, required=True)
    parser.add_argument("--npy", type=int, default=1)
    parser.add_argument("--route", default="structured",
                        choices=("structured", "hetero", "general"))
    parser.add_argument("--init-method", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=args.init_method,
                            rank=args.rank, world_size=args.npx * args.npy)
    try:
        if args.npy > 1:
            group = sharding.make_shard_group_2d(args.npx, args.npy, "cpu")
        else:
            group = sharding.make_shard_group(args.npx, "cpu")
        out = os.path.join(args.out, "out")
        sim = sharding.shard_simulation(
            build(args.route, args.npx, args.npy, out), group)
        manager, sim.output = sim.output, None
        ck = CheckpointManager(os.path.join(args.out, "ck"))
        frames = {k: [] for k in ("u", "v", "a", "t", "ppermute", "gather")}
        for frame in range(FRAMES):
            [tel] = sim.run(1, checkpoint_manager=ck,
                            checkpoint_every=CHECKPOINT_EVERY)
            collectives.reset_counts()
            manager.handle_from_stepper(tel.simulation_time, frame, sim.stepper)
            frames["ppermute"].append(collectives.ppermute.calls)
            frames["gather"].append(collectives.gather.calls)
            frames["t"].append(tel.simulation_time)
            for key, name in zip("uva", FIELDS):
                frames[key].append(gathered(sim, name))
        manager.flush()
        ck.wait()

        resumed = sharding.shard_simulation(build(args.route, args.npx,
                                                  args.npy), group)
        start = resumed.stepper.restore_checkpoint(ck)
        resumed.run(FRAMES - start)
        same = [bool(np.array_equal(gathered(sim, f), gathered(resumed, f)))
                for f in FIELDS]
        scalars = [getattr(s.stepper, k) for s in (sim, resumed)
                   for k in ("current_dt", "accumulated_time", "frame_index")]
        derived = {}
        if args.route != "general":
            from civiwave_tpu_torch.post import structured_fields as fields

            got = fields.gather_derived(sim.model, fields.compute_structured_derived(
                sim.model, sim.stepper.state.displacement))
            if got is not None:
                derived = {f"derived{i}": t.numpy() for i, t in enumerate(got)}
        if group.rank == 0:
            np.savez(os.path.join(args.out, "result.npz"),
                     **{k: np.array(v) for k, v in frames.items()},
                     resumed_from=start, resumed_equal=np.array(same),
                     scalars_equal=scalars[:3] == scalars[3:],
                     steps=np.array(ck.steps()), **derived)
    finally:
        sharding.close_shard_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
