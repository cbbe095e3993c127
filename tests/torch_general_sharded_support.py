"""One rank of the sharded-path checks of ``test_torch_general_sharded``.

Run as a script, once per rank (torch and the port only, no jax)::

    python tests/torch_general_sharded_support.py --rank R --world N \\
        --init-method file:///.../store --cases CASES.json --out DIR

Each rank joins a gloo group of N ranks and runs every case of the JSON
list in order.  A case shards a model and either steps it once (a
``newmark_step`` at dt 1e-3, tol 1e-7, at most 500 iterations, as the
reference's sharding tests) or solves it statically (tol 1e-8); rank 0
writes ``DIR/<name>.npz``: the gathered displacement and acceleration in
nodal rows, the PCG iterations and converged flag, and the collective
counts of the step (from after sharding to its end), and every rank adds
whether its shard ran the halo operator.  Cases:

* ``{"name", "mesh": [nx, ny, nz], "hex": bool, "env": {...}}``: the steel
  cantilever over a box mesh on the general path, packed with
  ``pad_nodes = pad_elems = 8 N`` (the reference's packing for N devices)
  and cut by ``shard_general`` (``env``: variables set for this case);
* ``{"name", "grid": [nx, ny, nz], "npy": k, "absorb": [faces]}``: the
  steel cantilever on the structured route, padded for an (N / k, k)
  group (2-D when k > 1), with absorbing faces, cut by
  ``shard_structured``;
* either with ``"static": true``: ``solve_static`` instead of a step.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from civiwave_tpu_torch.mesh import pack, preprocess  # noqa: E402
from civiwave_tpu_torch.mesh import structured as tstructured  # noqa: E402
from civiwave_tpu_torch.parallel import collectives, sharding  # noqa: E402
from civiwave_tpu_torch.physics import materials  # noqa: E402
from civiwave_tpu_torch.solver.static import solve_static  # noqa: E402
from civiwave_tpu_torch.solver.stepper import newmark_step  # noqa: E402
from civiwave_tpu_torch.utils.synthetic import box_mesh, cantilever_config  # noqa: E402

DT, TOL, MAX_ITERS, STATIC_TOL = 1.0e-3, 1.0e-7, 500, 1.0e-8


def _general(case, world):
    cfg = cantilever_config()
    mesh = box_mesh(*case["mesh"], hex_elements=case["hex"])
    pre = preprocess.run(mesh, cfg)
    mats = [materials.make_properties(m) for m in cfg.materials]
    model, state, force = pack.build_packed_model(
        mesh, pre, cfg, mats, pad_nodes=8 * world, pad_elems=8 * world,
        device="cpu")
    return model, state, force


def _structured(case, world):
    mat = cantilever_config().materials[0]
    npy = case.get("npy", 1)
    model, force = tstructured.build_structured_model(
        *case["grid"], materials.make_properties(mat), mat.density,
        traction=(0.0, 0.0, -1.0e6), pad_x_multiple=world // npy,
        pad_y_multiple=npy, absorb_planes=tuple(case.get("absorb", ())),
        device="cpu")
    return model, model.zero_state(), force


def run_case(case, world, out_dir):
    saved = {k: os.environ.get(k) for k in case.get("env", {})}
    os.environ.update(case.get("env", {}))
    try:
        if "mesh" in case:
            model, state, force = _general(case, world)
            group = sharding.make_shard_group(world, "cpu")
            shard, s_state, s_force = sharding.shard_general(
                model, state, force, group)
        else:
            model, state, force = _structured(case, world)
            npy = case.get("npy", 1)
            group = (sharding.make_shard_group_2d(world // npy, npy, "cpu")
                     if npy > 1 else sharding.make_shard_group(world, "cpu"))
            shard, s_state, s_force = sharding.shard_structured(
                model, state, force, group)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    collectives.reset_counts()
    if case.get("static"):
        u, tel = solve_static(shard, s_force, tolerance=STATIC_TOL,
                              max_iterations=4000)
        a = torch.zeros_like(u)
    else:
        ray = materials.compute_rayleigh(cantilever_config().damping)
        out = newmark_step(shard, s_state, s_force, DT, TOL, MAX_ITERS,
                           rayleigh_alpha=ray.alpha, rayleigh_beta=ray.beta)
        u, a, tel = out.state.displacement, out.state.acceleration, out.pcg
    counts = dict(
        ppermute_calls=collectives.ppermute.calls,
        psum_calls=collectives.psum.calls,
        psum_f64_3=collectives.psum.shapes[(torch.float64, (3,))],
        psum_f64_4=collectives.psum.shapes[(torch.float64, (4,))],
        all_gather_calls=collectives.all_gather.calls,
    )
    halo = torch.tensor([int(getattr(shard, "halo", False))])
    dist.all_reduce(halo)
    u = model.to_nodal(sharding.gather(shard, u)).numpy()
    a = model.to_nodal(sharding.gather(shard, a)).numpy()
    if group.rank == 0:
        np.savez(os.path.join(out_dir, case["name"] + ".npz"),
                 displacement=u, acceleration=a,
                 iterations=int(tel.iterations),
                 converged=bool(tel.converged), halo_ranks=int(halo),
                 **counts)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--init-method", required=True)
    parser.add_argument("--cases", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    with open(args.cases, encoding="utf-8") as handle:
        cases = json.load(handle)
    dist.init_process_group("gloo", init_method=args.init_method,
                            rank=args.rank, world_size=args.world)
    try:
        for case in cases:
            run_case(case, args.world, args.out)
    finally:
        sharding.close_shard_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
