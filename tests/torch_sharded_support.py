"""One rank of the sharded-operator checks of ``test_torch_sharded_path``.

Run as a script, once per rank (it imports torch and the port, no jax)::

    python tests/torch_sharded_support.py --rank R --npx 2 --npy 2 \\
        --init-method file:///.../store --out result-R.json

(``--npy`` > 1 makes the group 2-D.)

Each rank joins a gloo group, builds the cantilever grid padded for the
group, shards it, and writes to ``--out`` what it found:

* its exchanged ghosts (of a seeded global vector, and the mask's from
  shard time) against the neighbours' edge planes and rows cut from the
  global arrays, zero past the global ends;
* the gathered sharded operator (the normal dispatch: ghost exchange + the
  plain K5) against the unsharded operator, and the ghost exchanges one
  matvec made.
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--npx", type=int, required=True)
    parser.add_argument("--npy", type=int, default=1)
    parser.add_argument("--cells", default="9,4,5")
    parser.add_argument("--init-method", required=True)
    parser.add_argument("--out", required=True)
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
        cfg = cantilever_config(mesh={"path": "synthetic://box/" + args.cells})
        model, schedule = try_build_structured(
            cfg, pad_x_multiple=args.npx, pad_y_multiple=args.npy, device="cpu"
        )
        x = torch.as_tensor(np.random.default_rng(7).standard_normal(
            model.vector_shape).astype(np.float32))
        sm, _, _ = sharding.shard_structured(
            model, model.zero_state(), schedule.base, group
        )
        x0, y0, (xl, yl) = sm.x0, sm.y0, sm.local_extent
        block = sharding.cut_block(x, x0, y0, xl, yl)
        result = {"ghost_err": 0.0, "bc_ghost_mismatch": 0, "end_nonzero": 0}
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
        with open(args.out, "w", encoding="utf-8") as handle:
            json.dump(result, handle)
    finally:
        sharding.close_shard_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
