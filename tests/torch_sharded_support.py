"""One rank of the sharded-operator checks of ``test_torch_sharded_path``
and ``test_torch_sharded_heterogeneous``.

Run as a script, once per rank (it imports torch and the port, no jax)::

    python tests/torch_sharded_support.py --rank R --npx 2 --npy 2 \\
        --init-method file:///.../store --out result-R.json [--hetero]

(``--npy`` > 1 makes the group 2-D.)

Each rank joins a gloo group, builds the cantilever grid padded for the
group, shards it, and writes to ``--out`` what it found:

* its exchanged ghosts (of a seeded global vector, and the mask's from
  shard time) against the neighbours' edge planes and rows cut from the
  global arrays, zero past the global ends;
* the gathered sharded operator (the normal dispatch: ghost exchange + the
  plain K5) against the unsharded operator, and the ghost exchanges one
  matvec made.

``--hetero`` gives the grid per-cell materials (:func:`hetero_cells`),
so the shard's operator is G3's plain shard version, and adds:

* the exchanges ``shard_structured`` made, and its ghost cells against
  those cut from the global cell grids (zero past the global ends);
* ``FRAMES`` Newmark frames of the shard ('auto' = fused there), each
  gathered, with the collectives they made, then one frame from rest at
  the reference's own setting (tol 1e-7, 500 iterations); rank 0 writes
  them to ``--frames-out`` (.npz).
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

from civiwave_tpu_torch.mesh.structured_config import try_build_structured  # noqa: E402
from civiwave_tpu_torch.ops import structured_sharded as tss  # noqa: E402
from civiwave_tpu_torch.parallel import collectives, sharding  # noqa: E402
from civiwave_tpu_torch.utils.synthetic import cantilever_config  # noqa: E402

SS, MF = np.float32(1.01), np.float32(3.7)
FRAMES = 4
HETERO_SEED = 11


def hetero_cells(dims, seed=HETERO_SEED):
    """lam0 (1 + U), mu0 (1 + U') per cell of the steel cantilever, U and U'
    uniform on [0, 1) from ``default_rng(seed)`` (the reference's own
    heterogeneous case, tests/test_sharding.py:468)."""
    from civiwave_tpu_torch.physics import materials

    lame = materials.make_properties(cantilever_config().materials[0]).lame
    rng = np.random.default_rng(seed)
    return (lame.lam * (1.0 + rng.uniform(0.0, 1.0, dims)),
            lame.mu * (1.0 + rng.uniform(0.0, 1.0, dims)))


def _build(cells, npx, npy, hetero):
    """(model, force) of the cantilever of ``cells`` padded for the group,
    with per-cell materials where ``hetero``."""
    if not hetero:
        cfg = cantilever_config(mesh={"path": "synthetic://box/"
                                      + ",".join(map(str, cells))})
        model, schedule = try_build_structured(
            cfg, pad_x_multiple=npx, pad_y_multiple=npy, device="cpu"
        )
        return model, schedule.base
    from civiwave_tpu_torch.mesh.structured import build_structured_model
    from civiwave_tpu_torch.physics import materials

    mat = cantilever_config().materials[0]
    lam, mu = hetero_cells(cells)
    return build_structured_model(
        *cells, materials.make_properties(mat), mat.density,
        traction=(0.0, 0.0, -1.0e6), pad_x_multiple=npx, pad_y_multiple=npy,
        lam_grid=lam, mu_grid=mu, device="cpu",
    )


def _stepper(model, state, force, tol, max_iters):
    from civiwave_tpu_torch.physics import materials
    from civiwave_tpu_torch.solver.stepper import NewmarkStepper

    cfg = cantilever_config(tol_runtime=tol, max_iters=max_iters, dt=1e-3,
                            adaptive=False)
    ray = materials.compute_rayleigh(cfg.damping)
    return NewmarkStepper(model, state, force, ray, cfg.solver, cfg.time)


def _hetero_checks(model, sm, state, sf, group, two_d, result, frames_out):
    """The ghost cells, then the frames (see the module docstring)."""
    x0, y0, (xl, yl) = sm.x0, sm.y0, sm.local_extent
    want = tss.cut_cell_ghosts(model.lam_grid, model.mu_grid, x0, y0, xl, yl,
                               two_d)
    got = sm.cell_ghosts
    result["cell_ghost_mismatch"] = sum(
        int((getattr(got, f) != getattr(want, f)).sum())
        for f in tss.CellGhosts._fields if getattr(want, f) is not None)
    result["cell_ghost_fields"] = [f for f in tss.CellGhosts._fields
                                   if getattr(got, f) is not None]
    px, py = group.coords
    ends = [got.x_lo] * (px == 0) + [got.y_lo] * (two_d and py == 0)
    result["cell_end_nonzero"] = sum(int(g.count_nonzero()) for g in ends)

    stepper = _stepper(sm, state, sf, 2e-4, 120)
    variant = stepper.pcg_variant()
    collectives.reset_counts()
    tel, us, accs = [], [], []
    for _ in range(FRAMES):
        tel.append(stepper.step(stepper.accumulated_time))
        us.append(stepper.displacement())
        accs.append(stepper.acceleration())
    counts = dict(ppermute_calls=collectives.ppermute.calls,
                  psum_calls=collectives.psum.calls,
                  psum_f64_3=collectives.psum.shapes[(torch.float64, (3,))],
                  psum_f64_4=collectives.psum.shapes[(torch.float64, (4,))],
                  all_gather_calls=collectives.all_gather.calls)
    tight = _stepper(sm, sm.zero_state(), sf, 1e-7, 500)
    tight_tel = tight.step(tight.accumulated_time)
    u_tight = tight.displacement()
    if group.rank == 0:
        np.savez(frames_out, variant=variant,
                 iterations=np.array([t.pcg_iterations for t in tel]),
                 converged=np.array([t.pcg_converged for t in tel]),
                 displacement=np.stack(us), acceleration=np.stack(accs),
                 tight_iterations=tight_tel.pcg_iterations,
                 tight_converged=tight_tel.pcg_converged,
                 tight_displacement=u_tight, **counts)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--npx", type=int, required=True)
    parser.add_argument("--npy", type=int, default=1)
    parser.add_argument("--cells", default="9,4,5")
    parser.add_argument("--init-method", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--hetero", action="store_true")
    parser.add_argument("--frames-out", default=None)
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    world = args.npx * args.npy
    two_d = args.npy > 1
    dist.init_process_group("gloo", init_method=args.init_method,
                            rank=args.rank, world_size=world)
    try:
        if two_d:
            group = sharding.make_shard_group_2d(args.npx, args.npy, "cpu")
        else:
            group = sharding.make_shard_group(args.npx, "cpu")
        cells = tuple(int(n) for n in args.cells.split(","))
        model, force = _build(cells, args.npx, args.npy, args.hetero)
        x = torch.as_tensor(np.random.default_rng(7).standard_normal(
            model.vector_shape).astype(np.float32))
        collectives.reset_counts()
        sm, state, sf = sharding.shard_structured(
            model, model.zero_state(), force, group
        )
        shard_exchanges = collectives.ppermute.calls
        x0, y0, (xl, yl) = sm.x0, sm.y0, sm.local_extent
        block = sharding.cut_block(x, x0, y0, xl, yl)
        result = {"ghost_err": 0.0, "bc_ghost_mismatch": 0, "end_nonzero": 0,
                  "shard_exchanges": shard_exchanges}
        got = tss.exchange_ghosts(block, group)
        want = tss.cut_ghosts(x, x0, y0, xl, yl, two_d)
        want_bc = tss.cut_ghosts(model.bc_mask, x0, y0, xl, yl, two_d)
        for field in tss.Ghosts._fields:
            g, w = getattr(got, field), getattr(want, field)
            if w is None:
                assert g is None and getattr(sm.bc_ghosts, field) is None
                continue
            result["ghost_err"] = max(result["ghost_err"],
                                      float((g - w).abs().max()))
            result["bc_ghost_mismatch"] += int(
                (getattr(sm.bc_ghosts, field) != getattr(want_bc, field)).sum())
        px, py = group.coords
        if px == 0:
            result["end_nonzero"] += int(got.x_lo.count_nonzero())
        if px == args.npx - 1:
            result["end_nonzero"] += int(got.x_hi.count_nonzero())
        collectives.reset_counts()
        out = sharding.gather_structured(sm.apply_keff(block, SS, MF), group)
        result["exchanges_per_matvec"] = collectives.ppermute.calls
        ref = model.apply_keff(x, SS, MF)
        result["op_rel_err"] = float((out - ref).abs().max() / ref.abs().max())
        result["op_equal"] = bool(torch.equal(out, ref))
        if args.hetero:
            _hetero_checks(model, sm, state, sf, group, two_d, result,
                           args.frames_out)
        with open(args.out, "w", encoding="utf-8") as handle:
            json.dump(result, handle)
    finally:
        sharding.close_shard_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
