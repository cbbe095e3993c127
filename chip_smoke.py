#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result:

1. require CUDA; print the card (``nvidia-smi`` name and power limit);
2. build the kernels from ``civiwave_tpu_torch/csrc`` with nvcc (sm_90a),
   one nvcc process per source, all at once;
3. structured route: hold each kernel (K1 keff_structured, K2
   pc_keff_structured with and without dots, K3 block_jacobi_apply, K6
   pcg_iteration_structured — one whole PCG iteration; K1, K2 and K6 are
   plane sweeps over 8x32 (y, z) tiles and 32-plane X chunks) against its
   plain PyTorch version on small grids, two odd grids with fixes on
   several faces (one ragged against the sweep's tile and chunk on every
   axis) and the full 255^3-cell grid; at 255^3 also K2's u against K3
   (bit-equal or the max error) and its w against K1(u) (bit-equal, else
   the run fails), and time kernel and plain version with CUDA events;
4. structured main path at full width — ``build_simulation`` on the
   255^3-cell steel cantilever (50,331,648 DOF) — for 8 frames on the
   'auto' (fused) PCG and 2 on 'classic': every frame converged, the state
   is finite, every kernel was launched and U1 (the fused loop's direction
   update) once per fused PCG iteration; then U1 against its plain version
   at (3, 256, 256, 256), f32 and f64, first and later calls, bit for bit,
   and timed; the stepper's three vector passes once a frame each, and
   each against its plain version there, on the hetero column's grid of
   odd planes and on the tet-66 cantilever's node rows, bit for bit, and
   timed;
4b. the megafused main path (``CIVIWAVE_MEGA_PCG=1``, set for this phase
   only): the same 255^3 cantilever for 8 'auto' frames, one K6 launch per
   PCG iteration: every frame converged, iterations within +-1 of phase
   4's fused frames, the loaded face within 2.5e-4 of max|u| of phase 4's,
   and a profile of one megafused and one split fused frame;
5. the cantilever_box example (24x8x8, gravity, curve-ramped traction,
   adaptive dt) for 10 frames on the GPU and on the CPU (plain versions),
   then again with ``CIVIWAVE_MEGA_PCG=1`` on the fused variant;
6. general gather path: hold K7 element_forces (tet and hex) and G1
   assemble_csr (CSR slices staged through shared memory; bit-equal to
   plain, else the run fails) against their plain versions on a 16^3 hex
   box, a 9^3 tet box, a mixed tet+hex box, a shuffled 12^3 hex box and
   both 66^3 boxes, and time them (CUDA events) at the 66^3 shapes;
7. general_matvec_throughput's workload: 32 chained matvecs on the 66^3
   hex box (902,289 DOF), GDOF/s, and G1's time there (D = 8);
8. the general main path at full width — ``build_simulation`` on the
   steel cantilever over ``synthetic://box/66,66,66,tet`` (1,724,976 tets,
   902,289 DOF) — for 8 frames: iterations, steps/s, peak memory, launches;
9. general_steps_per_s's workload: 8 Newmark steps on the shuffled
   (RCM-renumbered) 34^3 hex box (128,625 DOF) with a prebuilt
   preconditioner: steps/s and mean iterations (the reference recorded
   25.0);
10. examples/seismic_column_tet.yaml (tet Gmsh mesh, two materials, curve
    traction) for 10 frames on the GPU and on the CPU;
11. slender route: hold K4 interior_stencil (a plane sweep whose (y, z)
    tile and chunk follow the grid's shape) and G2 keff_boundary (envelope
    blocks and face-owned boundary nodes in one launch; constrained
    outputs exactly x) against their plain versions, and the split
    operator (sanitize + K4 + G2) against K1, on small and odd grids, a
    column-shaped grid, the soil column's grid and 255^3; print the ptxas
    registers and spills of both kernels, their SASS mix and beside it the
    plane sweeps' (K1/K5 f32 and f64, K2, K6: ptxas registers, stack and
    spills, whole kernel and each stencil block, the factored interior, the
    class table and the z-face ghosts), and K4's geometry; time K4 (CUDA
    events per call and device events; every tile and chunk K4 is built
    for; one cuDNN conv3d in full f32, the yardstick), G2 (both timings)
    and the split operator against K1;
12. the slender main path at full width — ``build_simulation`` on
    ``soil_column_config()`` (1023x47x47 cells, 7,077,888 DOF, absorbing
    base) — for 8 frames on 'auto' (= classic there): every frame
    converged, K4 and G2 once per matvec, K1, K2 and K6 never; then 3
    frames on the K4 route against 3 on the K1 route (the route switched
    inside this script only);
13. examples/seismic_basin.yaml (five absorbing faces) for 10 frames on the
    GPU and on the CPU, then the basin at synthetic://box/255,255,255 for 4
    frames (K1 and K2 without in-kernel dots, the face term outside them);
14. sharded route, in this process and without a process group: cut the
    reference's sharded grids ((6,3,3) over 8 slabs, (15,4,4) over 4,
    (9,4,5) on 2x4 tiles with dead +Y rows, (7,7,3) on 2x2) and 255^3 (4
    slabs, 2x2 tiles, the whole slab) into blocks with their neighbours'
    ghosts; hold K5 keff_structured_halo (K1's plane sweep over a plane
    range, ghost planes and rows staged from their own buffers) against
    its plain version on every block, the gathered blocks against K1 and
    the overlap split's three launches against one (both bit for bit);
    time K5 on a 64-plane and the 256-plane slab beside K1 on the same
    nodes;
15. the sharded main path at full width: the 255^3 cantilever from
    ``build_simulation``, sharded over a one-rank NCCL group
    (``shard_structured``), 8 'auto' (= fused) frames with the overlap
    split, then 3 over a one-rank 2-D group (the ghost-Y form) and 3 with
    ``CIVIWAVE_HALO_OVERLAP=0``: every frame converged, iterations within
    +-1 of phase 4's fused frames, u and a against phase 4's (and the
    later runs against the first's frame 3), K5 three launches per matvec
    with the split and one without, K3 once per iteration and setup, K1,
    K2 and K6 never, one f64 (3,) all-reduce per PCG iteration, 2 or 4
    ghost exchanges per matvec; steps/s, ms per iteration, peak memory
    and the busy share of one profiled frame;
16. static mode: examples/static_cantilever.yaml through the CLI
    (``--static --output --telemetry-json``) on the GPU ('auto' = fused)
    and the CPU (classic): converged, u of the two VTU files within 2.5e-4
    of max|u| (the other arrays at 3e-3) and against a direct f64 solve of
    the dense oracle's system, the tip within 10 % of beam theory; the same
    beam meshed with tets through ``run_static`` on both (K7 tet and G1);
    then the 255^3 cantilever (50,331,648 DOF) solved statically through
    ``build_simulation`` and ``run_static`` on 'auto' (fused, K2), 'classic'
    (K1 + K3) and the K6 loop (``CIVIWAVE_MEGA_PCG=1`` for that run): every
    solve converged within 6,000 iterations, K6 once per megafused
    iteration; classic's u within 2.5e-4 of max|u| of its own u refined
    twice in f64 (mixed-precision iterative refinement), fused and
    megafused within 2.5e-4 of each other, every variant's error against
    the refined solution, its iterations against classic's and its true
    f64 residual printed; the first writes VTU frame
    0, read back (header, displacement block max = max|u|) and removed;
17. output: examples/cantilever_box.yaml ``--output`` for 10 frames on the
    GPU and the CPU (the same VTU frames, arrays and probe rows within the
    BASELINE tolerances); the 255^3 cantilever stepped 8 frames with the
    structured output manager (probes on the loaded face's corners and at
    mid-span, VTU frame 0 written on the writer thread while frames 1-7
    step): iterations within +-1 of phase 4's, the probe rows against the
    device node fields at 1e-5 of max|.|, steps/s beside phase 4's, the
    derived fields' device time, the probe cost per frame, the VTU's size
    and write time; examples/seismic_basin.yaml meshed with tets (the
    general path with five absorbing faces) for 10 frames with output on
    the GPU and the CPU at 24x24x12, then 8 frames at 80x80x40 (1,536,000
    tets, 807,003 DOF): one dashpot term per step matvec, its device
    kernels, steps/s, ms per iteration and peak memory;
18. geometric multigrid (``solver.preconditioner: multigrid``): the 255^3
    cantilever through ``build_simulation`` with its hierarchy (level
    shapes, omegas, build time); K1 on every level at the step's ss and mf
    against the plain operator (which reads the stored P^T m_f mass; the
    coarse levels' mass correction after K1 included, K1's error without
    it printed); the V-cycle on the card against the V-cycle of the plain
    versions and its K1 launches; 8 'auto' (= classic) frames: every frame
    converged, K1 the only kernel, as many launches as the frames' matvecs
    and V-cycles need, iterations, steps/s, ms per iteration, peak memory
    and a profiled frame; the static solve through ``run_static`` against
    phase 16's refined u (within 2.5e-4); 8 frames at tol 1e-8 with
    multigrid and with block-Jacobi classic (u and a at the BASELINE
    tolerances) and the distance of the 2e-4 runs from that converged
    trajectory; 8 frames with multigrid against 8 with block-Jacobi on
    96x56x56 cells (945,459 DOF);
19. pipelined PCG (``solver.variant: pipelined``, ``replace_every`` 10):
    8 frames of the 255^3 cantilever (every frame converged, iterations
    within max(3, 20 %) of phase 4's fused frames, u within 2.5e-4, K2
    once per setup, loop body and replacement), its static solve against
    phase 16's refined u (a stall is printed; a breakdown or a non-finite
    u fails), classic and pipelined static solves of the 63^3, 127^3 and
    191^3 cantilevers (iterations by size), 8 frames of the 66^3 tet
    cantilever (K7 + G1) against phase
    8's classic frames, and 3 frames of the 255^3 grid on a one-rank NCCL
    shard (K3 + K5; one f64 (3,) all-reduce per loop body, 2 ghost
    exchanges per matvec) against the unsharded pipelined frame 3;
20. the f64 instances (``precision.vectors: fp64``): K1 f64 at 255^3, on
    the soil column's grid and a ragged grid, K5 f64 on the 64-plane slabs
    of 255^3 with their ghosts (gathered against K1 f64 bit for bit), K3
    f64 at 255^3, K7 f64 and G1 f64 on the 66^3 tet and hex boxes, each
    against its plain version in f64 at 1e-12 of max|ref| (G1 bit-equal),
    timed beside the f32 instance, with its bound at the f64 rate and the
    ptxas lines of the four double instances;
21. fp64 through build_simulation on every path: cantilever_box at tol
    1e-10, 10 frames GPU vs CPU (iterations +-1, u 1e-8, a 1e-6 of max);
    the 255^3 cantilever, 8 frames ('auto' = classic: K1 f64 + K3 f64 once
    per matvec and pc apply, no f32 kernel) against 8 f32 classic frames at
    the BASELINE tolerances, steps/s, ms per iteration, peak memory and a
    profiled frame; its static solve (classic, tol 1e-8) against phase
    16's refined u; the 66^3 tet cantilever (K7 tet + G1 f64) and the soil
    column (K1 f64, not K4 + G2) against their f32 frames; 3 steps of the
    shuffled 34^3 hex box (K7 hex f64); multigrid against block-Jacobi at
    96x56x56, tol 1e-10, 3 frames (u within 1e-8 of max); a one-rank shard
    (classic, K5 f64 + K3 f64) against the unsharded frame 3;
22. checkpoints at 255^3: 6 'auto' frames saving every 3, a fresh
    build_simulation restores frame 3's checkpoint and runs to the same
    end: u, v, a and the warm start bit for bit; bytes, save and restore
    seconds;
23. ``--profile`` through ``runner.main`` on cantilever_box on the card:
    the trace names the reference's ranges and holds K1/K2 device events;
24. the general path's banded halo cut, in this process and without a
    group: phase 8's 66^3 tet cantilever and the 66^3 hex box cut into 4
    and 8 shards (``local_general_shards``; L, G and E_s printed); each
    shard's K7 on its (L + G)-row window and G1 over its L + G rows
    against the plain versions (G1 bit-equal), the combined shards
    against the unsharded K7 + G1 at 1e-5 of max|ref| (whether the rows
    off the ghost bands are bit-equal is printed), K7 + G1 per shard timed
    beside the unsharded call;
25. phase 8's tet cantilever through ``shard_simulation`` over a one-rank
    NCCL group (the single-device operator with the group's reductions;
    'auto' = classic there, as in the reference): 8 frames against phase
    8's (iterations +-1, u 2.5e-4, a 3e-3 of max), K7 and G1 once per
    matvec; frame 9 profiled beside phase 8's; then 3 fused frames with
    one f64 (3,) all-reduce per iteration and no exchange or all-gather;
26. phase 13's 255^3 basin (five absorbing faces) over a one-rank 1-D and
    a one-rank 2-D group, 4 frames each, against phase 13's (iterations
    +-1, u and a at the stepping tolerances; K5 and K3 only); the face
    terms of 4 slabs and 2x2 tiles in this process against the global
    term, bit for bit;
27. the 255^3 static cantilever, classic, on a one-rank shard (K5 + K3)
    through ``run_static``: converged, u within 2.5e-4 of max|u| of phase
    16's refined u, iterations beside phase 16's classic;
28. with two or more GPUs, ``parallel.launch --npx 2 --against-one-rank``
    on the 66^3 tet cantilever (with ``--profile``: rank 0's summaries)
    and on examples/seismic_basin.yaml (a failed check fails the run),
    then ``--output --checkpoint-dir`` on the 63^3 cantilever over 2 ranks
    against 1 (the same files, VTU arrays at the stepping tolerances, the
    2-rank checkpoint restored into the unsharded build equal to the last
    VTU's u); with one GPU it prints that it skipped;
29. heterogeneous grids (per-cell lam0 (1 + U), mu0 (1 + U') from
    ``default_rng(SEED)``): G3 corner_gather (a plane sweep: per cell
    plane an element stage, FFMA in f32 and DMMA tensor-core products in
    f64, then a gather stage) with its ptxas registers and spills, against
    its plain version on ``G3_SHAPES`` (grids that cut its tiles and
    chunks) and at 255^3 in f32 (1e-5 of max|ref|) and f64 (1e-12),
    constrained outputs equal to x, timed at 255^3 beside its bound and
    the torch-composition yardstick (the packed [A; B] product through
    ``torch.matmul`` and 8 slice adds; G3 must beat it); G3 against K1 on
    the uniform 255^3 grid marked heterogeneous (3e-6 of max|K1 x|); a
    multigrid request
    (the note on stderr, the model unchanged on block-Jacobi); the 255^3
    heterogeneous cantilever through ``build_structured_model(...,
    lam_grid=, mu_grid=)`` and ``NewmarkStepper``, 8 'auto' (= classic)
    frames: converged, finite, the tip deflects, iterations within 1 of
    ``HETERO_ITERS``, G3 once per iteration and
    twice per frame and no other kernel (K1, K2, K3, K4, K6, K5, G2),
    iterations, steps/s, ms per iteration, the per-node preconditioner's
    apply and build ms, peak memory and a profiled frame; its static solve
    through ``solve_static`` (tol 1e-6); 3 fp64 frames on G3's f64
    instance alone against the f32 frames (iterations within 1, u and a
    at the BASELINE tolerances); a
    16x4x4 heterogeneous box for 10 frames on the GPU and the CPU.
    Phase 4 also fails if the homogeneous main path launches G3;
30. heterogeneous grids on a shard: G3 over the 255^3 grid's slab and
    tile cuts against the whole-grid G3 and its plain shard version,
    timed on a 64-plane slab; 8 frames on one-rank 1-D and 2-D groups
    against the unsharded fused frames, fp64 frames and a static solve;
31. a shard's checkpoints, output, derived fields and probes at full
    width: phase 17b's scenario (255^3, probes, a VTU every 8 frames)
    through ``shard_simulation`` over one-rank 1-D and 2-D groups, 8
    frames with a checkpoint every 4 (iterations within 1 of phase 17b's,
    the output directory against phase 17b's at the stepping tolerances,
    the collectives the output made, frame 4's checkpoint resumed
    bit-equal, the derived fields and probe rows bit-equal to the
    unsharded functions' on the same state; steps/s, derived-field and
    probe ms, VTU seconds, checkpoint bytes and seconds); the
    heterogeneous 255^3 cantilever over a one-rank 1-D group (G3), 4
    frames; the 66^3 tet cantilever over a one-rank general group (K7 +
    G1), 3 frames (the VTU's u is the gathered state); each checkpoint
    resumed bit-equal;
32. the native Gmsh parser built with g++ here (a missing toolchain fails
    the run): the 34^3 tet box written as Gmsh 4.1 text parsed natively
    and in Python (array for array equal, both timed), the 66^3 tet box
    parsed natively (timed);
33. ``InteractiveSession`` on the 255^3 cantilever (two equal point-load
    requests bit-equal, reset exact, K2 launched, round trips timed) and
    ``viewer.start_in_thread`` on the 66^3 tet cantilever on the card
    (the page, the mesh, a solve with a point load, reset, seconds).

Output files of phases 16-17, 22-23 and 28b-33 go to a fresh directory
under ``civiwave_tpu_torch/_build/`` (ignored by git) and are removed
(phase 17b's by phase 31, which compares against it).  Any
failed check exits non-zero.  The last two lines of stdout are a JSON
summary of the kernels and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
FULL = (255, 255, 255)
# tolerances: operator / pc outputs at 1e-5 * max|ref|,
# dots at rtol 1e-5; trajectories at the BASELINE stepping tolerances
OP_TOL = 1e-5
DOT_RTOL = 1e-5
U_TOL, A_TOL = 2.5e-4, 3e-3
# least bytes per node a kernel must move: K1 and K3 read one f32 vector
# (12 B) and the mask (3 B) and write one vector; K2 writes two; K6 reads
# the six carries and the mask and writes the six carries
KERNEL_BYTES_PER_NODE = {"keff": 27, "bj": 27, "pc": 39, "k6": 147}
# least f32 operations per node: the 27-neighbour 3x3 block stencil
# (27 * 9 multiply-adds) plus the mass term and select; the 3x3 symmetric
# class-table product; K2 both plus its three dot partials; K6 that plus the
# p/s recurrence and the x/r axpys (4 multiply-adds per component)
KERNEL_FLOPS_PER_NODE = {"keff": 498, "bj": 15, "pc": 531, "k6": 560}
# U1 (the fused loop's direction update): x, r, p, s, u and w read and x,
# r, p and s written once (12 B a node each in f32, 24 in f64) and the mask
# (3 B); 24 operations a node (a product and a sum for each of p, s, x, r)
U1_BYTES_PER_NODE = {torch.float32: 123, torch.float64: 243}
U1_FLOPS_PER_NODE = 24
# the stepper's three passes (csrc/newmark_vectors.cu), least bytes a node
# (f32 vectors, 12 B a node each, f64 24; f32 mass, 1-byte mask
# components): rhs reads u, v, a, f and the mass and writes u_pred, d and
# rhs; the clamp reads rhs, K d and the mask and writes rhs; the update
# reads x, u_pred, v, a and writes u, v, a.  Operations a node: 57 (19 a
# component), 6, 21
NEWMARK_PASSES = ("newmark_rhs", "newmark_rhs_clamp", "newmark_update")
NEWMARK_BYTES_PER_NODE = {torch.float32: (88, 39, 84), torch.float64: (172, 75, 168)}
NEWMARK_FLOPS_PER_NODE = (57, 6, 21)
MEGA = "CIVIWAVE_MEGA_PCG"  # the opt-in switch of the whole-iteration path
HBM_TBPS = 3.35  # H100 SXM published device-memory bandwidth at 700 W
F32_TFLOPS = 67.0  # H100 SXM published f32 rate outside the tensor cores
GENERAL_N = 66  # bench.py's general-path box (66^3 cells, 902,289 DOF)
ITERS_REF = 25.0  # BENCH_r05: PCG iterations per step, 34^3 shuffled box
COLUMN = (1023, 47, 47)  # soil_column_config's cells: 1024x48x48 nodes
BASIN = "examples/seismic_basin.yaml"
# least bytes per node: K4 reads xs and writes out; G2 reads interior, x
# and the mask and writes out.  G2's least f32 operations: 12 per node
# (subtract, scale and mass FMA per component) plus 2 per nonzero ghost
# tap at each boundary-class node (counted from the run's grid)
K4_BYTES_PER_NODE, G2_BYTES_PER_NODE, G2_FLOPS_PER_NODE = 24, 39, 12


def fail(message: str) -> None:
    print(f"FAIL: {message}", flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int) -> float:
    """Mean device milliseconds per launch of the kernels whose names
    contain ``kernel`` (one per call), over ``reps`` calls of ``fn`` after
    one warm-up, from torch.profiler's device events: unlike time_ms, the
    host's own cost per call (a wrapper's checks) cannot pass for the
    kernel's time when it is the longer of the two."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # on the H100 machine the profiler records only some of a window's
    # device events now and then (17-18 of 20, or none): each call of fn
    # launches one such kernel, so the mean is taken over the events
    # recorded, and a window with none is taken again, at most 3 times
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type != DeviceType.CPU and kernel in e.key]
        total = sum(e.self_device_time_total for e in rows)
        events = sum(e.count for e in rows)
        if total > 0:
            if events < reps:
                print(f"  {events} of {reps} device events recorded for "
                      f"{kernel}: the mean is over those", flush=True)
            return total / 1e3 / events
        print(f"  no device time recorded for {kernel}; profiling again",
              flush=True)
    fail(f"no device time recorded for {kernel} in 3 profiler windows")


def bound(nbytes: float, flops: float, tflops: float = F32_TFLOPS):
    """(least ms, "bytes" | "operations"): the larger of the bytes over
    the card's memory rate and the operations over its rate for their type
    (f32 unless ``tflops`` says otherwise)."""
    t_bytes = nbytes / (HBM_TBPS * 1e12) * 1e3
    t_ops = flops / (tflops * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, out, ref, rel):
    """Max abs error of ``out`` against ``ref``, and that error over
    max|ref| (the quantity the tolerance bounds)."""
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if not math.isfinite(err) or err > rel * scale + 1e-30:
        fail(f"{name}: max abs err {err:.3e} > {rel:g} * max|ref| {scale:.3e}")
    return err, err / max(scale, 1e-300)


def kernel_phase(device):
    """Phase 3: every kernel against its plain version."""
    from civiwave_tpu_torch.mesh.structured import build_structured_model
    from civiwave_tpu_torch.ops.cuda import block_jacobi_apply as k3
    from civiwave_tpu_torch.ops.cuda import pcg_iteration as k6
    from civiwave_tpu_torch.ops.cuda import structured_stencil as k12
    from civiwave_tpu_torch.physics import materials
    from civiwave_tpu_torch.solver.stepper import effective_scalars
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    cfg = cantilever_config()
    mat = materials.make_properties(cfg.materials[0])
    rho = cfg.materials[0].density
    ray = materials.compute_rayleigh(cfg.damping)
    ss, mf = effective_scalars(1.0e-3, ray.alpha, ray.beta)
    rng = np.random.default_rng(SEED)
    cases = [
        ("5x4x3 fixes x0,z1", (5, 4, 3), dict(fixed_axis_planes=("x0", "z1"))),
        ("1x3x2", (1, 3, 2), {}),
        ("6x5x4 pad_x4", (6, 5, 4), dict(pad_x_multiple=4)),
        ("37x23x11 fixes x0,y1,z0 partial", (37, 23, 11), dict(fixes=[
            ("x0", (True, True, True), (None, None, None)),
            ("y1", (False, True, False), (None, None, None)),
            ("z0", (True, False, True), (None, None, None)),
        ])),
        # 34x20x46 nodes: ragged against the 8x32 (y, z) tile and the
        # 32-plane X chunk of K2's and K6's sweep, a face in every direction
        ("33x19x45 fixes x0,y1,z0 partial, ragged", (33, 19, 45), dict(fixes=[
            ("x0", (True, True, True), (None, None, None)),
            ("y1", (False, True, False), (None, None, None)),
            ("z0", (True, False, True), (1e-3, None, None)),
        ])),
        ("255x255x255", FULL, {}),
    ]
    results = {}
    for label, dims, kw in cases:
        model, _ = build_structured_model(*dims, mat, rho, device=device, **kw)
        pc = model.build_preconditioner(ss, mf)
        x = torch.as_tensor(
            rng.standard_normal(model.vector_shape, dtype=np.float32),
            device=device,
        )
        # name -> (max abs err, max abs err / max|ref|)
        errs = {}
        errs["keff"] = check_close(
            f"K1 {label}", k12.apply_keff_fused(model, x, ss, mf),
            k12.apply_keff_fused_plain(model, x, ss, mf), OP_TOL,
        )
        errs["bj"] = check_close(
            f"K3 {label}", k3.apply_block_jacobi(model, pc.table, x),
            k3.apply_block_jacobi_plain(model, pc.table, x), OP_TOL,
        )
        u, w, dots = k12.apply_pc_keff_fused(
            model, pc.table, x, ss, mf, with_dots=True
        )
        u_ref, w_ref, dots_ref = k12.apply_pc_keff_fused_plain(
            model, pc.table, x, ss, mf, with_dots=True
        )
        u2, w2 = k12.apply_pc_keff_fused(model, pc.table, x, ss, mf)
        torch.cuda.synchronize()
        errs["pc_u"] = check_close(f"K2 u {label}", u, u_ref, OP_TOL)
        errs["pc_w"] = check_close(f"K2 w {label}", w, w_ref, OP_TOL)
        check_close(f"K2 u (no dots) {label}", u2, u_ref, OP_TOL)
        check_close(f"K2 w (no dots) {label}", w2, w_ref, OP_TOL)
        for name, a, b in zip(("gamma", "delta", "rr"), dots, dots_ref):
            a, b = float(a), float(b)
            if not abs(a - b) <= DOT_RTOL * abs(b):
                fail(f"K2 dot {name} {label}: {a!r} vs plain {b!r}")
            errs[f"dot_{name}"] = (abs(a - b), abs(a - b) / max(abs(b), 1e-300))
        del u, w, u_ref, w_ref, u2, w2
        # K6: one whole PCG iteration on random carries; the kernel updates
        # x, u and p in place, so it gets copies
        gen = torch.Generator(device=device).manual_seed(SEED)
        carries = tuple(
            torch.randn(model.vector_shape, generator=gen, device=device)
            for _ in range(6)
        )
        k6_args = (torch.tensor(0.3, device=device),
                   torch.tensor(0.2, device=device), ss, mf)
        refs, dots_ref = k6.pcg_iteration_fused_plain(
            model, pc.table, carries, *k6_args)
        outs, dots = k6.pcg_iteration_fused(
            model, pc.table, tuple(c.clone() for c in carries), *k6_args)
        torch.cuda.synchronize()
        k6_errs = [check_close(f"K6 {name} {label}", o, r, OP_TOL)
                   for name, o, r in zip("xruwps", outs, refs)]
        errs["k6"] = (max(a for a, _ in k6_errs), max(r for _, r in k6_errs))
        for name, a, b in zip(("gamma", "delta", "rr"), dots, dots_ref):
            a, b = float(a), float(b)
            if not abs(a - b) <= DOT_RTOL * abs(b):
                fail(f"K6 dot {name} {label}: {a!r} vs plain {b!r}")
            errs[f"k6_dot_{name}"] = (abs(a - b), abs(a - b) / max(abs(b), 1e-300))
        del refs, outs
        print(f"kernels vs plain [{label}] abs/rel err: " + ", ".join(
            f"{k}={a:.3e}/{r:.2e}" for k, (a, r) in errs.items()), flush=True)
        results[label] = (model, pc, x, errs, carries, k6_args)

    model, pc, x, errs, carries, k6_args = results["255x255x255"]
    # K2 against the kernels it fuses: u = K3(r), w = K1(u); K1 and K2 are
    # one sweep, so w must equal K1(u) bit for bit
    u, w = k12.apply_pc_keff_fused(model, pc.table, x, ss, mf)
    for name, out, ref in (
        ("u vs K3", u, k3.apply_block_jacobi(model, pc.table, x)),
        ("w vs K1(u)", w, k12.apply_keff_fused(model, u, ss, mf)),
    ):
        torch.cuda.synchronize()
        err, rel = check_close(f"K2 {name} 255^3", out, ref, OP_TOL)
        same = torch.equal(out, ref)
        print(f"K2 {name} 255^3: " + ("bit-equal" if same else
              f"max abs err {err:.3e} ({rel:.2e} of max|ref|), "
              f"{int((out != ref).sum()):,} of {out.numel():,} values differ"),
              flush=True)
        if name.startswith("w") and not same:
            fail("K2's w differs from K1 of its u")
    del u, w
    work = tuple(c.clone() for c in carries)
    times = {
        "keff": (
            time_ms(lambda: k12.apply_keff_fused(model, x, ss, mf), 20),
            time_ms(lambda: k12.apply_keff_fused_plain(model, x, ss, mf), 3),
        ),
        "bj": (
            time_ms(lambda: k3.apply_block_jacobi(model, pc.table, x), 20),
            time_ms(lambda: k3.apply_block_jacobi_plain(model, pc.table, x), 3),
        ),
        "pc": (
            time_ms(lambda: k12.apply_pc_keff_fused(
                model, pc.table, x, ss, mf, with_dots=True), 20),
            time_ms(lambda: k12.apply_pc_keff_fused_plain(
                model, pc.table, x, ss, mf, with_dots=True), 3),
        ),
        "k6": (
            time_ms(lambda: k6.pcg_iteration_fused(
                model, pc.table, work, *k6_args), 20),
            time_ms(lambda: k6.pcg_iteration_fused_plain(
                model, pc.table, carries, *k6_args), 3),
        ),
    }
    nodes = int(np.prod(model.grid_shape))
    for key, (ms, plain_ms) in times.items():
        # computed least traffic: each f32 vector and the bool mask once
        gbytes = KERNEL_BYTES_PER_NODE[key] * nodes / 1e9
        print(f"time 255^3 {key}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"({nodes:,} nodes; {gbytes:.3f} GB computed least traffic -> "
              f"{gbytes / ms:.3f} TB/s, {gbytes / ms / HBM_TBPS:.3f} of "
              f"{HBM_TBPS} TB/s)", flush=True)
    # drop the 255^3 tensors before the main path allocates its own
    del results, model, pc, x, carries, work
    torch.cuda.empty_cache()
    return errs, times


def main_path_phase(device):
    """Phase 4: the port's main path at full width."""
    from civiwave_tpu_torch.ops.cuda import block_jacobi_apply as k3
    from civiwave_tpu_torch.ops.cuda import newmark_vectors as nv
    from civiwave_tpu_torch.ops.cuda import pcg_vector_update as u1
    from civiwave_tpu_torch.ops.cuda import structured_stencil as k12
    from civiwave_tpu_torch.runner import build_simulation
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    cfg = cantilever_config(
        tol_runtime=2e-4, max_iters=120, dt=1e-3, adaptive=False,
        mesh={"path": "synthetic://box/%d,%d,%d" % FULL},
    )
    t0 = time.perf_counter()
    sim = build_simulation(cfg, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dof = sim.model.dof_count
    if dof != 3 * int(np.prod([n + 1 for n in FULL])):
        fail(f"main path DOF {dof:,} does not match the {FULL} grid")

    torch.cuda.reset_peak_memory_stats()
    k12.apply_keff_fused.launches = 0
    k12.apply_pc_keff_fused.launches = 0
    k3.apply_block_jacobi.launches = 0
    u1.cg_direction_update.launches = 0
    u1.cg_direction_update.launches_f64 = 0
    for name in NEWMARK_PASSES:
        setattr(getattr(nv, name), "launches", 0)
        setattr(getattr(nv, name), "launches_f64", 0)
    reset_g3_counts()

    frame_s, telemetries = [], []
    for variant, frames in (("auto", 8), ("classic", 2)):
        sim.stepper.solver_variant = variant
        for _ in range(frames):
            t0 = time.perf_counter()
            telemetries += sim.run(1)
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
        if variant == "auto":  # the fused frames' result, for 4b and 15
            # U1: one launch per iteration of the fused loop, f32 only
            u1_launches = u1.cg_direction_update.launches
            fused_iters = sum(t.pcg_iterations for t in telemetries)
            if (u1_launches != fused_iters
                    or u1.cg_direction_update.launches_f64):
                fail(f"main path: U1 launched {u1_launches} times (f64 "
                     f"{u1.cg_direction_update.launches_f64}) over "
                     f"{fused_iters} fused PCG iterations")
            u8 = sim.stepper.state.displacement
            split = dict(tip=u8[2, FULL[0]].clone(), umax=float(u8.abs().max()),
                         u=u8.cpu(), a=sim.stepper.state.acceleration.cpu())

    launches = {
        "keff": k12.apply_keff_fused.launches,
        "pc": k12.apply_pc_keff_fused.launches,
        "bj": k3.apply_block_jacobi.launches,
        "u1": u1_launches,
    }
    if u1.cg_direction_update.launches != u1_launches:
        fail("main path: the classic frames launched U1")
    # the stepper's passes: each once a frame (the cantilever has beta_R >
    # 0), f32 only, on fused and classic frames alike
    newmark = {name: (getattr(nv, name).launches, getattr(nv, name).launches_f64)
               for name in NEWMARK_PASSES}
    if any(n != (len(frame_s), 0) for n in newmark.values()):
        fail(f"main path: the stepper's passes launched {newmark} (f32, f64) "
             f"times over {len(frame_s)} frames, not once a frame each")
    launches["newmark"] = sum(n for n, _ in newmark.values())
    peak = torch.cuda.max_memory_allocated()
    iters = [t.pcg_iterations for t in telemetries]
    if not all(t.pcg_converged for t in telemetries):
        fail(f"main path: not every frame converged: {iters}")
    state = sim.stepper.state
    for name in ("displacement", "velocity", "acceleration"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            fail(f"main path: non-finite {name}")
    for key, n in launches.items():
        if n <= 0:
            fail(f"main path never launched kernel {key}")
    if any(g3_counts().values()):  # a homogeneous grid never takes G3
        fail(f"main path launched G3: {g3_counts()}")
    tip = float(state.displacement[2, FULL[0]].min())
    if not tip < 0.0:
        fail(f"main path: the loaded face did not deflect (min u_z {tip})")
    steady = frame_s[1:8]  # fused frames after the first (pc build)
    print(f"main path: {dof:,} DOF, model build {build_s:.3f} s", flush=True)
    print(f"main path: pcg iterations per frame {iters} "
          f"(fused mean {np.mean(iters[:8]):.2f}, classic {iters[8:]})", flush=True)
    print("main path: frame seconds " + ", ".join(f"{s:.4f}" for s in frame_s),
          flush=True)
    print(f"main path: fused steps/s {len(steady) / sum(steady):.4f} "
          f"(frames 2-8), classic steps/s {2 / sum(frame_s[8:]):.4f}", flush=True)
    split.update(iters=iters[:8], steps_per_s=len(steady) / sum(steady),
                 ms_per_iter=sum(steady) / sum(iters[1:8]) * 1e3)
    print(f"main path: fused ms per iteration {split['ms_per_iter']:.4f} "
          f"(frames 2-8, host clock)", flush=True)
    print(f"main path: peak device memory {peak / 2**30:.3f} GiB "
          f"({peak} bytes)", flush=True)
    print(f"main path: kernel launches {launches}; tip u_z {tip:.6e} m",
          flush=True)
    del sim, state
    torch.cuda.empty_cache()
    split["u1"] = direction_update_check(device)
    split["newmark"] = newmark_vectors_check(device)
    return launches, split


def direction_update_check(device):
    """Phase 4's U1 block: the fused loop's direction update against its
    plain version (the torch composition it replaced) at the main path's
    shape (3, 256, 256, 256) on a random mask, f32 and f64, a solve's first
    call and a later one, bit for bit (every value's bits, so -0.0 against
    +0.0 counts), and both timed with CUDA events (later calls, in place
    on copies; the first call's time beside them)."""
    from civiwave_tpu_torch.ops.cuda import pcg_vector_update as u1

    shape = (3, *(n + 1 for n in FULL))
    nodes = int(np.prod(shape[1:]))
    gen = torch.Generator(device=device).manual_seed(SEED)
    bc = torch.rand(shape, generator=gen, device=device) < 0.3
    alpha = torch.tensor(0.37134791250387, dtype=torch.float64, device=device)
    beta = torch.tensor(-0.61927358129, dtype=torch.float64, device=device)
    result = {}
    for dtype, label in ((torch.float32, "f32"), (torch.float64, "f64")):
        bits = torch.int32 if dtype == torch.float32 else torch.int64
        vecs = [torch.randn(shape, generator=gen, device=device, dtype=dtype)
                for _ in range(6)]
        x, r, p, s, u, w = vecs
        for call, b in (("first", None), ("later", beta)):
            ref = u1.cg_direction_update_plain(bc, x, r, p, s, u, w, alpha, b, dtype)
            got = u1.cg_direction_update(
                bc, x.clone(), r.clone(), p.clone(), s.clone(), u, w, alpha, b,
                dtype)
            torch.cuda.synchronize()
            for name, g, want in zip("xrps", got, ref):
                if not torch.equal(g.view(bits), want.view(bits)):
                    fail(f"U1 {label} {call} call 255^3: {name} differs from "
                         f"the plain version in {int((g != want).sum()):,} of "
                         f"{g.numel():,} values")
            del ref, got
        work = [x.clone(), r.clone(), p.clone(), s.clone()]

        def later():
            u1.cg_direction_update(bc, *work, u, w, alpha, beta, dtype)

        def first():
            u1.cg_direction_update(bc, work[0], work[1], None, None, u, w,
                                   alpha, None, dtype)

        ms = time_ms(later, 20)
        ms_first = time_ms(first, 20)
        plain_ms = time_ms(lambda: u1.cg_direction_update_plain(
            bc, x, r, p, s, u, w, alpha, beta, dtype), 3)
        least = U1_BYTES_PER_NODE[dtype] * nodes
        tflops = F32_TFLOPS if dtype == torch.float32 else F64_TFLOPS
        print(f"U1 {label} 255^3: first and later calls bit-equal to the plain "
              f"version", flush=True)
        result[label] = report_time(
            f"255^3 U1 {label}", "x".join(map(str, shape)), ms, plain_ms,
            least, U1_FLOPS_PER_NODE * nodes, tflops=tflops)
        result[label]["ms_first"] = ms_first
        del vecs, x, r, p, s, u, w, work
        torch.cuda.empty_cache()
    return result


# the layouts the stepper's passes run on the main paths: the 255^3
# cantilever's grid, the soil-over-rock column's grid (planes of an odd
# node count) and the 66^3 tet cantilever's node rows (67^3 nodes padded
# to a multiple of 8), each with its mass: (1, X, Y, Z) or (N*, 1)
NEWMARK_LAYOUTS = (("255^3", (3, *(n + 1 for n in FULL))),
                   ("hetero 641x161x161", (3, 641, 161, 161)),
                   ("tet-66 rows", (300_768, 3)))


def newmark_vectors_check(device):
    """Phase 4's block of the stepper's three passes: each against its
    plain version (the torch composition it replaced) on every layout of
    ``NEWMARK_LAYOUTS`` with a random mask, f32 and f64, with K d and delta
    written, bit for bit, and kernel and plain version timed with CUDA
    events.  Returns {layout: {"f32": ..., "f64": ...}}."""
    from civiwave_tpu_torch.ops.cuda import newmark_vectors as nv

    k = nv.NewmarkScalars(
        dt=1e-3, c_pred=0.25e-6, a0=4e6, a2=4e3, a3=1.0, a1=2e3, a4=1.0, a5=0.0,
        alpha_r=0.36363636363636365, beta_r=3.6363636363636364e-4,
        c_vpred=0.5e-3, c_v=2e3, c_a=4e6)
    result = {}
    for layout, shape in NEWMARK_LAYOUTS:
        grid = len(shape) == 4
        nodes = int(np.prod(shape[1:])) if grid else shape[0]
        gen = torch.Generator(device=device).manual_seed(SEED)
        bc = torch.rand(shape, generator=gen, device=device) < 0.3
        bc_value = 1e-3 * torch.randn(shape, generator=gen, device=device)
        mass_shape = (1, *shape[1:]) if grid else (nodes, 1)
        mass = 7800.0 * (1.0 + torch.rand(mass_shape, generator=gen, device=device))
        result[layout] = {}
        for dtype, label in ((torch.float32, "f32"), (torch.float64, "f64")):
            bits = torch.int32 if dtype == torch.float32 else torch.int64
            u, v, a, f, x, kd = (
                scale * torch.randn(shape, generator=gen, device=device, dtype=dtype)
                for scale in (1e-4, 1e-2, 10.0, 1e5, 1e-4, 1e7))
            ref_a = nv.newmark_rhs_plain(mass, u, v, a, f, k)
            got_a = nv.newmark_rhs(mass, u, v, a, f, k)
            ref_b = nv.newmark_rhs_clamp_plain(ref_a[2], kd, None, bc, bc_value, k)
            got_b = nv.newmark_rhs_clamp(got_a[2], kd, None, bc, bc_value, k)
            ref_c = nv.newmark_update_plain(x, ref_a[0], v, a, k, True)
            got_c = nv.newmark_update(x, got_a[0], v, a, k, True)
            torch.cuda.synchronize()
            pairs = [("u_pred", got_a[0], ref_a[0]), ("d", got_a[1], ref_a[1]),
                     ("rhs", got_b, ref_b),
                     *zip(("u", "v", "a", "delta"), got_c, ref_c)]
            for name, g, want in pairs:
                if not torch.equal(g.view(bits), want.view(bits)):
                    fail(f"newmark passes {label} {layout}: {name} differs from "
                         f"the plain version in {int((g != want).sum()):,} of "
                         f"{g.numel():,} values")
            u_pred, rhs = got_a[0], got_b
            del pairs, ref_a, ref_b, ref_c, got_a, got_b, got_c
            calls = (
                (lambda: nv.newmark_rhs(mass, u, v, a, f, k),
                 lambda: nv.newmark_rhs_plain(mass, u, v, a, f, k)),
                (lambda: nv.newmark_rhs_clamp(rhs, kd, None, bc, bc_value, k),
                 lambda: nv.newmark_rhs_clamp_plain(rhs, kd, None, bc, bc_value, k)),
                (lambda: nv.newmark_update(x, u_pred, v, a, k),
                 lambda: nv.newmark_update_plain(x, u_pred, v, a, k, False)))
            tflops = F32_TFLOPS if dtype == torch.float32 else F64_TFLOPS
            print(f"newmark passes {label} {layout}: rhs, clamp and update "
                  f"bit-equal to the plain versions", flush=True)
            passes = {}
            for name, (kernel, plain), nbytes, flops in zip(
                    NEWMARK_PASSES, calls, NEWMARK_BYTES_PER_NODE[dtype],
                    NEWMARK_FLOPS_PER_NODE):
                passes[name] = report_time(
                    f"{layout} {name} {label}", "x".join(map(str, shape)),
                    time_ms(kernel, 20), time_ms(plain, 3), nbytes * nodes,
                    flops * nodes, tflops=tflops)
            total = {key: sum(p[key] for p in passes.values())
                     for key in ("ms", "plain_ms", "bound_ms")}
            print(f"newmark passes {label} {layout}: the three {total['ms']:.4f} "
                  f"ms, plain {total['plain_ms']:.4f} ms, bound "
                  f"{total['bound_ms']:.4f} ms ({total['bound_ms'] / total['ms']:.3f} "
                  f"of it)", flush=True)
            result[layout][label] = dict(
                total, bound_by="bytes", library_ms=None,
                passes={n: p["ms"] for n, p in passes.items()})
            del u, v, a, f, x, kd, u_pred, rhs, calls
            torch.cuda.empty_cache()
        del bc, bc_value, mass
    return result


def structured_counts():
    """Launch counters of the structured route's kernels, by short name."""
    from civiwave_tpu_torch.ops.cuda import block_jacobi_apply as k3
    from civiwave_tpu_torch.ops.cuda import keff_halo as k5
    from civiwave_tpu_torch.ops.cuda import pcg_iteration as k6
    from civiwave_tpu_torch.ops.cuda import structured_stencil as k12

    return {"k6": k6.pcg_iteration_fused.launches,
            "pc": k12.apply_pc_keff_fused.launches,
            "keff": k12.apply_keff_fused.launches,
            "bj": k3.apply_block_jacobi.launches,
            "k5": k5.keff_structured_halo.launches}


def reset_structured_counts():
    from civiwave_tpu_torch.ops.cuda import block_jacobi_apply as k3
    from civiwave_tpu_torch.ops.cuda import keff_halo as k5
    from civiwave_tpu_torch.ops.cuda import pcg_iteration as k6
    from civiwave_tpu_torch.ops.cuda import structured_stencil as k12

    k6.pcg_iteration_fused.launches = 0
    k12.apply_pc_keff_fused.launches = 0
    k12.apply_keff_fused.launches = 0
    k3.apply_block_jacobi.launches = 0
    k5.keff_structured_halo.launches = 0


def mega_main_path_phase(device, split):
    """Phase 4b: the megafused main path at full width, against phase 4's
    split fused frames (``split``: their iterations, the loaded face's u_z
    after frame 8 and max|u|)."""
    from civiwave_tpu_torch.runner import build_simulation
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    cfg = cantilever_config(
        tol_runtime=2e-4, max_iters=120, dt=1e-3, adaptive=False,
        mesh={"path": "synthetic://box/%d,%d,%d" % FULL},
    )
    os.environ[MEGA] = "1"
    try:
        sim = build_simulation(cfg, device=device)
        sim.stepper.solver_variant = "auto"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_structured_counts()
        frame_s, telemetries = [], []
        for _ in range(8):
            t0 = time.perf_counter()
            telemetries += sim.run(1)
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
        launches = structured_counts()
        peak = torch.cuda.max_memory_allocated()
        iters = [t.pcg_iterations for t in telemetries]
        if not all(t.pcg_converged for t in telemetries):
            fail(f"megafused main path: not every frame converged: {iters}")
        state = sim.stepper.state
        for name in ("displacement", "velocity", "acceleration"):
            if not bool(torch.isfinite(getattr(state, name)).all()):
                fail(f"megafused main path: non-finite {name}")
        if launches["k6"] != sum(iters) or launches["k6"] <= 0:
            fail(f"megafused main path: {launches['k6']} K6 launches for "
                 f"{sum(iters)} PCG iterations")
        for key in ("pc", "keff"):
            if launches[key] <= 0:
                fail(f"megafused main path never launched kernel {key}")
        if any(abs(a - b) > 1 for a, b in zip(iters, split["iters"])):
            fail(f"megafused main path: iterations {iters} not within 1 of "
                 f"the split fused frames' {split['iters']}")
        tip_err = float((state.displacement[2, FULL[0]] - split["tip"]).abs().max())
        if not tip_err <= U_TOL * split["umax"]:
            fail(f"megafused main path: loaded face u_z differs by {tip_err:.3e} "
                 f"> {U_TOL:g} * max|u| {split['umax']:.3e}")
        steady = frame_s[1:]
        ms_per_iter = sum(steady) / sum(iters[1:]) * 1e3
        print(f"megafused main path: pcg iterations per frame {iters} (split "
              f"fused {split['iters']})", flush=True)
        print("megafused main path: frame seconds " + ", ".join(
            f"{t:.4f}" for t in frame_s), flush=True)
        print(f"megafused main path: steps/s {len(steady) / sum(steady):.4f} "
              f"(frames 2-8; split fused {split['steps_per_s']:.4f}), "
              f"{ms_per_iter:.4f} ms per iteration (split fused "
              f"{split['ms_per_iter']:.4f})", flush=True)
        print(f"megafused main path: peak device memory {peak / 2**30:.3f} GiB "
              f"({peak} bytes)", flush=True)
        print(f"megafused main path: kernel launches {launches} = K6 "
              f"{launches['k6'] / sum(iters):.3f} per iteration, K2 "
              f"{launches['pc'] / 8:.3f} and K1 {launches['keff'] / 8:.3f} per "
              f"frame; loaded face u_z max abs diff from the split run "
              f"{tip_err:.3e} ({tip_err / split['umax']:.3e} of max|u|)",
              flush=True)
        profile_window("megafused main path frame 9", lambda: sim.run(1))
    finally:
        os.environ.pop(MEGA, None)
    profile_window("split fused main path frame 10", lambda: sim.run(1))
    del sim, state
    torch.cuda.empty_cache()
    return launches


def cantilever_box_config():
    """examples/cantilever_box.yaml as a parsed Config (no pyyaml needed)."""
    from civiwave_tpu_torch.config.loader import parse_config_node

    return parse_config_node({
        "mesh": {"path": "synthetic://box/24,8,8"},
        "materials": [{"name": "concrete", "E": 3.0e10, "nu": 0.2, "rho": 2500.0}],
        "assignments": [{"group": "SOLID", "material": "concrete"}],
        "damping": {"xi": 0.02, "w1": 10.0, "w2": 100.0},
        "time": {"dt": 0.002, "adaptive": True, "min_dt": 0.0005, "max_dt": 0.01},
        "solver": {"type": "pcg", "preconditioner": "block_jacobi",
                   "tol_runtime": 2.0e-4, "tol_pause": 1.0e-5, "max_iters": 120},
        "precision": {"vectors": "fp32", "reductions": "fp64"},
        "curves": {"ramp": [[0.0, 0.0], [0.05, 1.0]]},
        "loads": {"gravity": [0.0, 0.0, -9.81],
                  "tractions": [{"group": "LOAD_FACE", "value": [0.0, 0.0, -2.0e5],
                                 "scale_curve": "ramp"}]},
        "dirichlet": {"fixes": [{"group": "FIXED", "dof": ["x", "y", "z"]}]},
        "output": {"vtu_stride": 5, "probes": [0]},
    })


def trajectory_phase(device, mega=False):
    """Phase 5: the example scenario on the GPU against the CPU; with
    ``mega`` both run the fused variant with the whole-iteration path (K6
    on the GPU, its plain version on the CPU)."""
    from civiwave_tpu_torch.runner import build_simulation

    cfg = cantilever_box_config()
    runs = {}
    if mega:
        os.environ[MEGA] = "1"
    try:
        for dev in (device, "cpu"):
            sim = build_simulation(cfg, device=dev)
            if mega:
                sim.stepper.solver_variant = "fused"
            reset_structured_counts()
            tel = sim.run(10)
            runs[dev] = (tel, sim.stepper.state, structured_counts())
    finally:
        os.environ.pop(MEGA, None)
    (tg, sg, counts), (tc, sc, _) = runs[device], runs["cpu"]
    if mega and counts["k6"] != sum(t.pcg_iterations for t in tg):
        fail(f"trajectory (megafused): {counts['k6']} K6 launches for "
             f"{sum(t.pcg_iterations for t in tg)} PCG iterations")
    it_g = [t.pcg_iterations for t in tg]
    it_c = [t.pcg_iterations for t in tc]
    if any(abs(a - b) > 1 for a, b in zip(it_g, it_c)):
        fail(f"trajectory: iterations differ by more than 1: {it_g} vs {it_c}")
    if [t.time_step for t in tg] != [t.time_step for t in tc]:
        fail("trajectory: dt sequences differ")
    if not all(t.pcg_converged for t in tg):
        fail(f"trajectory: GPU frames not all converged: {it_g}")
    errs = {}
    for name, tol in (("displacement", U_TOL), ("acceleration", A_TOL)):
        _, errs[name] = check_close(
            f"trajectory {name}", getattr(sg, name).cpu(), getattr(sc, name), tol
        )
    print(f"cantilever_box 10 frames{' megafused' if mega else ''}: "
          f"iterations gpu {it_g} cpu {it_c}; "
          f"max abs err / max|cpu| u {errs['displacement']:.3e} "
          f"(tol {U_TOL:g}), a {errs['acceleration']:.3e} (tol {A_TOL:g})",
          flush=True)


# --- general gather path -------------------------------------------------

# least f32 operations per element of K7 (per Gauss point: G = 9 sums of
# NL products, the trace, S, and f += grad^T S; plus the volume scale)
K7_FLOPS = {"tet": 171, "hex": 2520}


def general_counts():
    """Launch counters of the general path's kernels, by JSON name."""
    from civiwave_tpu_torch.ops.cuda import assemble_csr as g1
    from civiwave_tpu_torch.ops.cuda import element_forces as k7

    return {
        "element_forces_tet": k7.tet_element_forces.launches,
        "element_forces_hex": k7.hex_element_forces.launches,
        "assemble_csr": g1.assemble_keff.launches,
    }


def reset_general_counts():
    from civiwave_tpu_torch.ops.cuda import assemble_csr as g1
    from civiwave_tpu_torch.ops.cuda import element_forces as k7

    k7.tet_element_forces.launches = 0
    k7.hex_element_forces.launches = 0
    g1.assemble_keff.launches = 0


def packed_model(mesh, cfg, device, **pads):
    """Preprocess + pack a mesh on ``device`` (host seconds printed)."""
    from civiwave_tpu_torch.mesh import pack, preprocess
    from civiwave_tpu_torch.physics import materials

    t0 = time.perf_counter()
    pre = preprocess.run(mesh, cfg)
    mats = [materials.make_properties(m) for m in cfg.materials]
    model, _state, force = pack.build_packed_model(
        mesh, pre, cfg, mats, device=device, **pads
    )
    torch.cuda.synchronize()
    return model, force, time.perf_counter() - t0


def random_vector(model, device):
    gen = torch.Generator(device=device).manual_seed(SEED)
    return torch.randn(model.vector_shape, generator=gen, device=device)


def check_general_kernels(label, model, x, ss, mf):
    """K7 (each block present) and G1 against their plain versions, and
    the whole operator against its plain form; returns {name: (abs, rel)}."""
    from civiwave_tpu_torch.ops import apply_keff as gops
    from civiwave_tpu_torch.ops.cuda import assemble_csr as g1
    from civiwave_tpu_torch.ops.cuda import element_forces as k7

    errs = {}
    for block, wrapper, count in (
        ("tet", k7.tet_element_forces, model.padded_tet_count),
        ("hex", k7.hex_element_forces, model.padded_hex_count),
    ):
        if count:
            errs[f"element_forces_{block}"] = check_close(
                f"K7 {block} {label}", wrapper(model, x, ss),
                k7.element_forces_plain(model, x, ss, block), OP_TOL,
            )
    rows = k7.element_force_rows(model, x, ss)
    for name, m in (("assemble_csr", mf), ("assemble_csr mf=0", 0.0)):
        out = g1.assemble_keff(model, rows, x, m)
        ref = g1.assemble_keff_plain(model, rows, x, m)
        errs[name] = check_close(f"G1 {label} ({name})", out, ref, OP_TOL)
        if not torch.equal(out, ref):  # one thread per node, in slot order
            fail(f"G1 {label} ({name}): not bit-equal to the plain version")
    errs["apply_keff"] = check_close(
        f"apply_keff {label}", gops.apply_keff(model, x, ss, mf),
        gops.apply_keff_plain(model, x, ss, mf), OP_TOL,
    )
    torch.cuda.synchronize()
    print(f"general kernels vs plain [{label}: {model.tet_count:,} tets, "
          f"{model.hex_count:,} hexes, {model.node_count:,} nodes, D "
          f"{model.csr_degree}] abs/rel err: " + ", ".join(
              f"{k}={a:.3e}/{r:.2e}" for k, (a, r) in errs.items()), flush=True)
    return errs


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def time_k7(model, x, ss, block):
    """K7 on one block: (ms, plain ms, least bytes, least flops)."""
    from civiwave_tpu_torch.ops.cuda import element_forces as k7

    wrapper = k7.tet_element_forces if block == "tet" else k7.hex_element_forces
    out = torch.empty((model.force_row_count, 3), dtype=x.dtype, device=x.device)
    if block == "tet":
        tables = (model.conn_tet, model.grads_tet, model.vol_tet,
                  model.lam_tet, model.mu_tet)
        e, nl = model.tet_count, 4
        out = out[: model.padded_tet_count * 4]
    else:
        tables = (model.conn_hex, model.grads_hex, model.vol_hex,
                  model.lam_hex, model.mu_hex)
        e, nl = model.hex_count, 8
        out = out[model.padded_tet_count * 4:]
    ms = time_ms(lambda: wrapper(model, x, ss, out=out), 20)
    plain_ms = time_ms(lambda: k7.element_forces_plain(model, x, ss, block), 3)
    # the tables and the force rows as stored (padded elements included)
    least = nbytes(x, model.bc_mask, *tables, out)
    return ms, plain_ms, least, K7_FLOPS[block] * e


def time_g1(model, x, mf):
    """G1: (device ms, plain ms, least bytes, least flops, library ms).  The
    library call is one CSR sparse-dense product (torch.sparse.mm) over the
    same incidences — the gather-sum only, without mass and identity rows;
    timed as a yardstick, never used by the port."""
    from civiwave_tpu_torch.ops import apply_keff as gops
    from civiwave_tpu_torch.ops.cuda import assemble_csr as g1
    from civiwave_tpu_torch.ops.cuda import element_forces as k7

    rows = k7.element_force_rows(model, x, 1.0)
    # the kernel is shorter than the wrapper's host cost at D = 8: time it
    # by its device events, and print the per-call time beside it
    ms = device_ms(lambda: g1.assemble_keff(model, rows, x, mf),
                   "assemble_csr_kernel", 20)  # either instance's name
    call_ms = time_ms(lambda: g1.assemble_keff(model, rows, x, mf), 20)
    plain_ms = time_ms(lambda: g1.assemble_keff_plain(model, rows, x, mf), 3)
    real = model.csr_weight != 0
    nnz = int(real.sum())
    crow = torch.zeros(model.padded_node_count + 1, dtype=torch.int64,
                       device=x.device)
    crow[1:] = torch.cumsum(real.sum(dim=1), 0)
    incidence = torch.sparse_csr_tensor(
        crow, model.csr_idx[real].long(), model.csr_weight[real].to(rows.dtype),
        size=(model.padded_node_count, model.force_row_count),
        check_invariants=True,
    )
    library_ms = time_ms(lambda: torch.sparse.mm(incidence, rows), 20)
    lib_err = float(
        (torch.sparse.mm(incidence, rows) - gops.assemble(model, rows)).abs().max()
    )
    print(f"  G1 library yardstick torch.sparse.mm ({nnz:,} incidences): "
          f"{library_ms:.4f} ms, max abs diff from the plain gather-sum "
          f"{lib_err:.3e}; G1 kernel {ms:.4f} ms of device time, "
          f"{call_ms:.4f} ms per wrapper call (CUDA events)", flush=True)
    least = (nbytes(model.csr_idx, model.csr_weight, model.lumped_mass, x,
                    model.bc_mask) + nnz * 3 * rows.element_size() + nbytes(x))
    flops = 6 * nnz + 7 * model.padded_node_count
    return ms, plain_ms, least, flops, library_ms


def report_time(name, shape, ms, plain_ms, least, flops, library_ms=None,
                tflops=F32_TFLOPS):
    bound_ms, bound_by = bound(least, flops, tflops)
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
    print(f"time {name} [{shape}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
          f"{lib} ({least / 1e9:.4f} GB computed least traffic -> "
          f"{least / 1e9 / ms:.3f} TB/s, {least / 1e9 / ms / HBM_TBPS:.3f} of "
          f"{HBM_TBPS} TB/s; {flops / 1e9:.3f} GFLOP; bound {bound_ms:.4f} ms "
          f"by {bound_by})", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def general_small_kernel_phase(device, ss, mf):
    """Phase 6a: K7 and G1 against plain on the small general meshes."""
    from civiwave_tpu_torch.utils.synthetic import (
        box_mesh, cantilever_config, shuffle_mesh_nodes, split_last_hex)

    cfg = cantilever_config()
    cases = [
        ("hex 16^3", box_mesh(16, 16, 16, hex_elements=True)),
        ("tet 9^3", box_mesh(9, 9, 9)),
        ("mixed 8^3", split_last_hex(box_mesh(8, 8, 8, hex_elements=True))),
        ("shuffled hex 12^3",
         shuffle_mesh_nodes(box_mesh(12, 12, 12, hex_elements=True), seed=5)),
    ]
    for label, mesh in cases:
        model, _, _ = packed_model(mesh, cfg, device)
        if label.startswith("shuffled") and not model.renumbered:
            fail(f"{label}: pack did not renumber the shuffled mesh")
        check_general_kernels(label, model, random_vector(model, device), ss, mf)


def general_matvec_phase(device, ss, mf):
    """Phases 6b + 7: the 66^3 hex box — K7 hex against plain, its time,
    then general_matvec_throughput's 32 chained matvecs (bench.py:41-90,
    132-148: ss 1, mf 4e6, rescale 1/2e11, best of 5)."""
    from civiwave_tpu_torch.utils.synthetic import box_mesh, cantilever_config

    n = GENERAL_N
    cfg = cantilever_config()
    model, _, build_s = packed_model(
        box_mesh(n, n, n, hex_elements=True), cfg, device,
        pad_nodes=1024, pad_elems=1024,
    )
    print(f"general matvec: 66^3 hex box packed in {build_s:.3f} s "
          f"({model.hex_count:,} hexes, {model.dof_count:,} DOF, D "
          f"{model.csr_degree}, renumbered {model.renumbered})", flush=True)
    x = random_vector(model, device)
    errs = check_general_kernels("hex 66^3", model, x, ss, mf)
    timing = report_time("K7 hex", "hex 66^3", *time_k7(model, x, ss, "hex"))
    # G1 at D = 8 (its main-path time is the tet box's, D = 24)
    g1_hex = report_time("G1", "hex 66^3", *time_g1(model, x, mf))

    inner = 32
    m_ss, m_mf, rescale = np.float32(1.0), np.float32(4.0e6), np.float32(1.0 / 2.0e11)

    def chain(v):
        for _ in range(inner):
            v = model.apply_keff(v, m_ss, m_mf) * rescale
        return v

    reset_general_counts()
    y = chain(x)
    torch.cuda.synchronize()
    counts = general_counts()
    if not bool(torch.isfinite(y).all()):
        fail("general matvec chain produced non-finite values")
    best = float("inf")
    for rep in range(5):
        x_rep = x + np.float32(1.0e-6 * (rep + 1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain(x_rep)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    gdofs = model.dof_count * inner / best / 1e9
    print(f"general_matvec_throughput: {gdofs:.4f} GDOF/s "
          f"({best / inner * 1e3:.4f} ms/matvec, best of 5 x {inner}; "
          f"{model.dof_count:,} DOF); launches in one chain {counts}",
          flush=True)
    del model, x, y
    torch.cuda.empty_cache()
    return errs, timing, g1_hex, gdofs


def profile_window(label, run):
    """Run ``run()`` once under torch.profiler and print
    ``utils.profiling.summary``: the wall time, the device busy share
    (device-side events over the window's wall time, which the profiler
    itself stretches: a lower bound), and the host operators and kernels
    with the most self time."""
    from torch.profiler import ProfilerActivity, profile

    from civiwave_tpu_torch.utils.profiling import summary

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"{label} profile: {summary(prof, wall_ms)}", flush=True)


def general_main_path_phase(device, ss, mf):
    """Phases 6c + 8: the general main path at full width through
    build_simulation, K7 tet and G1 held and timed on its model first."""
    from civiwave_tpu_torch.runner import build_simulation
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    n = GENERAL_N
    cfg = cantilever_config(
        mesh={"path": f"synthetic://box/{n},{n},{n},tet"}, dt=1e-3,
        adaptive=False, tol_runtime=2e-4, max_iters=300,
    )
    t0 = time.perf_counter()
    sim = build_simulation(cfg, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = sim.model
    if model.tet_count != 6 * n ** 3 or model.dof_count != 3 * (n + 1) ** 3:
        fail(f"general main path: {model.tet_count:,} tets / "
             f"{model.dof_count:,} DOF do not match the {n}^3 tet box")
    print(f"general main path: model build {build_s:.3f} s ({model.tet_count:,} "
          f"tets, {model.dof_count:,} DOF, D {model.csr_degree}, renumbered "
          f"{model.renumbered})", flush=True)
    x = random_vector(model, device)
    errs = check_general_kernels("tet 66^3", model, x, ss, mf)
    timings = {
        "element_forces_tet": report_time(
            "K7 tet", "tet 66^3", *time_k7(model, x, ss, "tet")),
        "assemble_csr": report_time(
            "G1", "tet 66^3", *time_g1(model, x, mf)),
    }
    del x
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_general_counts()
    frame_s, telemetries = [], []
    for _ in range(8):
        t0 = time.perf_counter()
        telemetries += sim.run(1)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    counts = general_counts()
    peak = torch.cuda.max_memory_allocated()
    iters = [t.pcg_iterations for t in telemetries]
    if not all(t.pcg_converged for t in telemetries):
        fail(f"general main path: not every frame converged: {iters}")
    state = sim.stepper.state
    for name in ("displacement", "velocity", "acceleration"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            fail(f"general main path: non-finite {name}")
    for key in ("element_forces_tet", "assemble_csr"):
        if counts[key] <= 0:
            fail(f"general main path never launched {key}")
    u, a = sim.stepper.displacement(), sim.stepper.acceleration()
    tip = float(u[np.isclose(sim.mesh.node_positions[:, 0], n), 2].min())
    if not tip < 0.0:
        fail(f"general main path: the loaded face did not deflect (min u_z {tip})")
    steady = frame_s[1:]
    print(f"general main path: pcg iterations per frame {iters} "
          f"(mean {np.mean(iters):.3f})", flush=True)
    print("general main path: frame seconds " + ", ".join(
        f"{t:.4f}" for t in frame_s), flush=True)
    print(f"general main path: steps/s {len(steady) / sum(steady):.4f} "
          f"(frames 2-8; frame 1 includes the pc build)", flush=True)
    print(f"general main path: peak device memory {peak / 2**30:.3f} GiB "
          f"({peak} bytes)", flush=True)
    print(f"general main path: kernel launches {counts}; tip u_z {tip:.6e} m",
          flush=True)
    profile_window("general main path frame 9", lambda: sim.run(1))
    del sim, model, state
    torch.cuda.empty_cache()
    # the 8 classic frames' result, for phase 19's pipelined frames,
    # phase 21's fp64 frames and phase 25's one-rank shard
    return errs, timings, counts, dict(iters=iters, u=u, a=a,
                                       steps_per_s=len(steady) / sum(steady))


def general_steps_phase(device):
    """Phase 9: general_steps_per_s's workload (bench.py:165-231)."""
    from civiwave_tpu_torch.physics import materials
    from civiwave_tpu_torch.solver.stepper import effective_scalars, newmark_step
    from civiwave_tpu_torch.utils.synthetic import (
        box_mesh, cantilever_config, shuffle_mesh_nodes)

    cfg = cantilever_config()
    model, force, build_s = packed_model(
        shuffle_mesh_nodes(box_mesh(34, 34, 34, hex_elements=True), seed=5),
        cfg, device, pad_nodes=1024, pad_elems=1024,
    )
    if not model.renumbered:
        fail("general steps: pack did not renumber the shuffled 34^3 box")
    ray = materials.compute_rayleigh(cfg.damping)
    pc = model.build_preconditioner(*effective_scalars(1.0e-3, ray.alpha, ray.beta))
    n_steps = 8

    def run_steps():
        state, iters = model.zero_state(), []
        for _ in range(n_steps):
            out = newmark_step(
                model, state, force, 1.0e-3, 2.0e-4, 120,
                rayleigh_alpha=ray.alpha, rayleigh_beta=ray.beta,
                preconditioner=pc,
            )
            state = out.state
            if not out.pcg.converged:
                fail(f"general steps: a step did not converge ({out.pcg})")
            iters.append(out.pcg.iterations)
        return state, iters

    reset_general_counts()
    state, iters = run_steps()
    torch.cuda.synchronize()
    counts = general_counts()
    if not bool(torch.isfinite(state.displacement).all()):
        fail("general steps: non-finite displacement")
    for key in ("element_forces_hex", "assemble_csr"):
        if counts[key] <= 0:
            fail(f"general steps never launched {key}")
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        _, rep_iters = run_steps()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        if rep_iters != iters:
            fail(f"general steps: iterations changed between runs "
                 f"{iters} vs {rep_iters}")
    profile_window("general steps (8 steps)", run_steps)
    mean = float(np.mean(iters))
    print(f"general_steps_per_s: {n_steps / best:.4f} steps/s at "
          f"{model.dof_count:,} DOF (pack {build_s:.3f} s, renumbered "
          f"{model.renumbered}; best of 3); iterations {iters}, mean "
          f"{mean:.3f} (reference {ITERS_REF}); launches {counts}", flush=True)
    if abs(mean - ITERS_REF) > 2.0:
        fail(f"general steps: mean iterations {mean} not within 2 of {ITERS_REF}")
    del model, force, pc, state
    torch.cuda.empty_cache()
    return counts


def column_trajectory_phase(device):
    """Phase 10: examples/seismic_column_tet.yaml, GPU against CPU."""
    from civiwave_tpu_torch.runner import build_simulation

    scenario = "examples/seismic_column_tet.yaml"
    runs = {}
    for dev in (device, "cpu"):
        sim = build_simulation(scenario, device=dev)
        tel = sim.run(10)
        runs[str(dev)] = (tel, sim.stepper)
    (tg, sg), (tc, sc) = runs[str(device)], runs["cpu"]
    it_g = [t.pcg_iterations for t in tg]
    it_c = [t.pcg_iterations for t in tc]
    if any(abs(a - b) > 1 for a, b in zip(it_g, it_c)):
        fail(f"column: iterations differ by more than 1: {it_g} vs {it_c}")
    if not all(t.pcg_converged for t in tg):
        fail(f"column: GPU frames not all converged: {it_g}")
    errs = {}
    for name, tol in (("displacement", U_TOL), ("acceleration", A_TOL)):
        got = torch.as_tensor(getattr(sg, name)())
        ref = torch.as_tensor(getattr(sc, name)())
        if not bool(torch.isfinite(got).all()):
            fail(f"column: non-finite {name}")
        _, errs[name] = check_close(f"column {name}", got, ref, tol)
    print(f"seismic_column_tet 10 frames: iterations gpu {it_g} cpu {it_c}; "
          f"max abs err / max|cpu| u {errs['displacement']:.3e} "
          f"(tol {U_TOL:g}), a {errs['acceleration']:.3e} (tol {A_TOL:g})",
          flush=True)


# --- slender route: K4 + G2, the soil column, the basin ------------------


def slender_counts():
    """Launch counters of the slender route's kernels, by short name."""
    from civiwave_tpu_torch.ops.cuda import interior_stencil as k4
    from civiwave_tpu_torch.ops.cuda import keff_boundary as g2

    return {"k4": k4.interior_stencil.launches, "g2": g2.keff_boundary.launches}


def reset_slender_counts():
    from civiwave_tpu_torch.ops.cuda import interior_stencil as k4
    from civiwave_tpu_torch.ops.cuda import keff_boundary as g2

    k4.interior_stencil.launches = 0
    g2.keff_boundary.launches = 0


def all_counts():
    return {**structured_counts(), **slender_counts()}


def reset_all_counts():
    reset_structured_counts()
    reset_slender_counts()


def column_model(device):
    """The soil column's model as the main path builds it, with the
    scenario's K_eff scalars at its dt."""
    from civiwave_tpu_torch.mesh.structured_config import try_build_structured
    from civiwave_tpu_torch.physics import materials
    from civiwave_tpu_torch.solver.stepper import effective_scalars
    from civiwave_tpu_torch.utils.synthetic import soil_column_config

    cfg = soil_column_config(cells=COLUMN)
    model, _ = try_build_structured(cfg, device=device)
    ray = materials.compute_rayleigh(cfg.damping)
    return model, effective_scalars(cfg.time.initial_dt, ray.alpha, ray.beta)


def g2_least(model):
    """G2's (least bytes, least f32 operations) on ``model``'s grid: the
    nonzero ghost taps at the neighbours on the model, per class."""
    from civiwave_tpu_torch.ops import structured as tops
    from civiwave_tpu_torch.ops.cuda import keff_boundary as g2

    X, Y, Z = model.grid_shape
    _, rows = g2.ghost_tap_rows(model.spacing, model.lam0, model.mu0)
    per_axis = [np.bincount(tops.axis_classes(n, c), minlength=3)
                for n, c in zip((X, Y, Z), (model.nx, model.ny, model.nz))]
    nodes = np.einsum("i,j,k->ijk", *per_axis).reshape(27)
    taps = np.count_nonzero(rows.reshape(27, -1), axis=1)
    ghost_flops = 2 * int((nodes * taps).sum())  # the interior class has none
    total = X * Y * Z
    return G2_BYTES_PER_NODE * total, G2_FLOPS_PER_NODE * total + ghost_flops


def conv3d_yardstick(xs, taps):
    """One cuDNN conv3d in full f32 (TF32 off) computing K4's function:
    (the call, its weight W[b, c, dx, dy, dz] = T[dx, dy, dz, b, c])."""
    import torch.nn.functional as F

    weight = torch.as_tensor(
        np.ascontiguousarray(np.transpose(taps, (3, 4, 0, 1, 2)), np.float32),
        device=xs.device,
    )
    return lambda: F.conv3d(xs[None], weight, padding=1)[0]


def ptxas_report(log, names):
    """The ptxas lines (entry, registers, spills) of the kernels whose
    mangled names contain one of ``names``."""
    lines, wanted = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            wanted = any(n in line for n in names)
        if wanted and ("Compiling entry" in line or "registers" in line
                       or "spill" in line):
            lines.append(line.strip())
    return lines


def sass_mix(path, names, top=6):
    """{kernel: [(opcode, count), ...]}: the commonest SASS instructions of
    each kernel in the built library whose mangled name contains one of
    ``names`` (cuobjdump beside nvcc; {} where the toolkit has none)."""
    import re
    from collections import Counter

    from civiwave_tpu_torch.ops.cuda import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=120).stdout
    mix, current = {}, None
    for line in text.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            current = name if any(n in name for n in names) else None
            if current:
                mix[current] = Counter()
            continue
        op = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if current and op:
            mix[current][op.group(1)] += 1
    return {name: counts.most_common(top) for name, counts in mix.items()}


SWEEP_KERNELS = ("keff_sweep_kernel", "pc_keff_sweep_kernel",
                 "pcg_iteration_sweep_kernel")
BLOCK_OPS = ("FFMA", "FADD", "FMUL", "DFMA", "DADD", "DMUL", "ULDC", "LDS",
             "LDG")


def sass_text(path):
    """The library's SASS (cuobjdump beside nvcc; "" where the toolkit has
    none)."""
    from civiwave_tpu_torch.ops.cuda import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return ""
    return subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=120).stdout


def sass_blocks(text, names):
    """{kernel: [Counter, ...]}: the opcode counts of every basic block,
    most FMAs first, of each kernel in the SASS ``text`` whose mangled
    name contains one of ``names``.  The plane sweeps' stencil is unrolled,
    so each branch of ``apply_plane`` is one block, run once per node and
    plane visit: its counts are the instructions a visit issues."""
    import re
    from collections import Counter

    found = {}
    for part in re.split(r"\s+Function : ", text)[1:]:
        name = part.split()[0]
        if not any(n in name for n in names):
            continue
        code = []
        for line in part.splitlines():
            m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                text_ = re.sub(r"^@!?U?P\w+\s+", "", m.group(2))
                code.append((int(m.group(1), 16), text_))
        # leaders: the first instruction, branch targets, and what follows
        # a branch, an exit or a barrier
        leaders = {code[0][0]} if code else set()
        for i, (_, ins) in enumerate(code):
            op = ins.split()[0].split(".")[0]
            target = re.search(r"\b(?:BRA|BRX|JMP|CALL\S*|BSSY)\b.*?(0x[0-9a-f]+)",
                               ins)
            if target:
                leaders.add(int(target.group(1), 16))
            if op in ("BRA", "BRX", "JMP", "EXIT", "RET", "CALL", "BSYNC",
                      "WARPSYNC", "BAR") and i + 1 < len(code):
                leaders.add(code[i + 1][0])
        blocks, current = [], Counter()
        for addr, ins in code:
            if addr in leaders and current:
                blocks.append(current)
                current = Counter()
            current[ins.split()[0].split(".")[0]] += 1
        blocks.append(current)
        blocks.sort(key=lambda c: -(c["FFMA"] + c["DFMA"]))
        found[name] = blocks
    return found


def stencil_role(counts):
    """Which branch of ``apply_plane`` a SASS block is, or None: the class
    table's (its 243 taps by LDG), the factored interior (27 LDS of the
    transformed plane, no LDG) or a z face's ghost taps (81 FMAs, no
    loads)."""
    fma = counts["FFMA"] + counts["DFMA"]
    if counts["LDG"] >= 243 and fma >= 243:
        return "class table"
    if counts["LDS"] == 27 and not counts["LDG"] and fma:
        return "interior"
    if fma >= 81 and not counts["LDS"] and not counts["LDG"]:
        return "z ghosts"
    return None


def print_sweep_sass(lib, label):
    """K1/K5 (f32, f64), K2's and K6's ptxas registers, stack and spills
    (K1/K5 and K2 are built for ``kSweepBlocksPerSm`` blocks an SM), their
    whole-kernel SASS mix and the mix of their largest stencil blocks: the
    interior branch (the factored stencil, constant-bank coefficients), the
    class-table branch (LDG taps) and the z-face ghost taps."""
    for line in ptxas_report(lib.log, SWEEP_KERNELS):
        print(f"  ptxas {label}: {line}", flush=True)
    text = sass_text(lib.path)
    for name, counts in sass_mix(lib.path, SWEEP_KERNELS, top=8).items():
        print(f"  SASS {label} {name[-44:]}: " + ", ".join(
            f"{op} {n}" for op, n in counts), flush=True)
    for name, blocks in sass_blocks(text, SWEEP_KERNELS).items():
        for c in blocks:
            role = stencil_role(c)
            if role is None:
                continue
            print(f"  SASS {label} {role} block {name[-44:]}: "
                  f"{sum(c.values())} instructions, " + ", ".join(
                      f"{op} {c[op]}" for op in BLOCK_OPS if c[op]),
                  flush=True)


def k4_candidates(xs, taps, label):
    """Device ms of K4 with every tile and chunk it is built for, beside
    the one its geometry function picks for this grid."""
    from civiwave_tpu_torch.ops.cuda import interior_stencil as k4
    from civiwave_tpu_torch.ops.cuda import plane_sweep

    chosen = plane_sweep.stencil_geometry(xs.shape[1:])
    found = {}
    for tile in plane_sweep.STENCIL_TILES:
        for chunk in plane_sweep.STENCIL_CHUNKS:
            geom = plane_sweep.stencil_geometry(xs.shape[1:], tile, chunk)
            found[(tile, chunk)] = device_ms(lambda: k4.launch(xs, taps, geom),
                                             "interior_sweep_kernel", 20)
    best = min(found, key=found.get)
    print(f"  K4 geometries [{label}] (device ms): " + ", ".join(
        f"{t[0]}x{t[1]}/{c} {ms:.4f}" for (t, c), ms in found.items())
        + f"; chosen {chosen.tile[0]}x{chosen.tile[1]}/{chosen.chunk}, "
        f"fastest {best[0][0]}x{best[0][1]}/{best[1]}", flush=True)
    return found


def slender_kernel_phase(device, ss, mf):
    """Phase 11: K4, G2 and the split operator against their plain versions
    and K1; times at the soil column's grid and at 255^3."""
    from civiwave_tpu_torch.mesh.structured import build_structured_model
    from civiwave_tpu_torch.ops import structured as tops
    from civiwave_tpu_torch.ops.cuda import _build, plane_sweep
    from civiwave_tpu_torch.ops.cuda import interior_stencil as k4
    from civiwave_tpu_torch.ops.cuda import keff_boundary as g2
    from civiwave_tpu_torch.ops.cuda import structured_stencil as k12
    from civiwave_tpu_torch.physics import materials
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    lib = _build.load_library()
    for line in ptxas_report(lib.log, ("interior_sweep_kernel",
                                       "keff_boundary_kernel")):
        print(f"  ptxas K4/G2: {line}", flush=True)
    # every variant holds all of its plane-window cases (K4: six)
    for name, counts in sass_mix(lib.path, ("interior_sweep_kernel",
                                            "keff_boundary_kernel")).items():
        print(f"  SASS K4/G2 {name[-40:]}: " + ", ".join(
            f"{op} {n}" for op, n in counts), flush=True)
    # beside them the plane sweeps', whole and per stencil branch
    print_sweep_sass(lib, "K1/K5/K2/K6")
    cfg = cantilever_config()
    mat = materials.make_properties(cfg.materials[0])
    rho = cfg.materials[0].density
    cases = [
        ("5x4x3 fixes x0,z1", (5, 4, 3), dict(fixed_axis_planes=("x0", "z1"))),
        ("1x3x2", (1, 3, 2), {}),
        ("3x1x1 fixes x0,x1", (3, 1, 1), dict(fixed_axis_planes=("x0", "x1"))),
        ("6x5x4 pad_x4", (6, 5, 4), dict(pad_x_multiple=4)),
        ("5x5x3 pad_y4", (5, 5, 3), dict(pad_y_multiple=4)),
        ("37x23x11 fixes x0,y1,z0 partial", (37, 23, 11), dict(fixes=[
            ("x0", (True, True, True), (None, None, None)),
            ("y1", (False, True, False), (None, None, None)),
            ("z0", (True, False, True), (None, None, None)),
        ])),
        ("2x3x300", (2, 3, 300), {}),
        ("39x47x47 column piece", (39, 47, 47), dict(fixed_axis_planes=())),
        ("soil column", None, None),
        ("255x255x255", FULL, {}),
    ]
    errs = {"k4": (0.0, 0.0), "g2": (0.0, 0.0), "split": (0.0, 0.0)}
    timing = {}
    for label, dims, kw in cases:
        if dims is None:
            model, (m_ss, m_mf) = column_model(device)
        else:
            model, _ = build_structured_model(*dims, mat, rho, device=device, **kw)
            m_ss, m_mf = ss, mf
        gen = torch.Generator(device=device).manual_seed(SEED)
        x = torch.randn(model.vector_shape, generator=gen, device=device)
        xs = x.masked_fill(model.bc_mask, 0.0)
        taps = tops.interior_taps(model)
        interior = k4.interior_stencil_plain(xs, taps)
        out_g2 = g2.keff_boundary(model, interior, x, m_ss, m_mf)
        found = {
            "k4": check_close(f"K4 {label}", k4.interior_stencil(xs, taps),
                              interior, OP_TOL),
            "g2": check_close(
                f"G2 {label}", out_g2,
                g2.keff_boundary_plain(model, interior, x, m_ss, m_mf), OP_TOL),
            "split": check_close(
                f"split vs K1 {label}",
                tops.apply_keff_split_structured(model, x, m_ss, m_mf),
                k12.apply_keff_fused(model, x, m_ss, m_mf), OP_TOL),
        }
        if not torch.equal(out_g2[model.bc_mask], x[model.bc_mask]):
            fail(f"G2 {label}: a constrained output is not x")
        torch.cuda.synchronize()
        for key, (a, r) in found.items():
            errs[key] = (max(errs[key][0], a), max(errs[key][1], r))
        geom = plane_sweep.stencil_geometry(model.grid_shape)
        print(f"slender kernels vs plain [{label}, grid {model.grid_shape}, K4 "
              f"tile {geom.tile[0]}x{geom.tile[1]} chunk {geom.chunk}, "
              f"{geom.blocks} blocks] abs/rel err: " + ", ".join(
                  f"{k}={a:.3e}/{r:.2e}" for k, (a, r) in found.items()),
              flush=True)
        if label not in ("soil column", "255x255x255"):
            continue
        nodes = int(np.prod(model.grid_shape))
        k4_candidates(xs, taps, label)
        conv = conv3d_yardstick(xs, taps)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            conv_err = float((conv() - interior).abs().max()) / float(
                interior.abs().max())
            conv_ms = time_ms(conv, 20)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        k4_flops = 2 * int(np.count_nonzero(taps)) * nodes
        g2_bytes, g2_flops = g2_least(model)
        # the kernels are about as short as their wrappers' host cost: time
        # them by their device events, with the per-call time beside
        k4_call = time_ms(lambda: k4.interior_stencil(xs, taps), 50)
        g2_call = time_ms(
            lambda: g2.keff_boundary(model, interior, x, m_ss, m_mf), 50)
        timing[label] = {
            "k4": report_time(
                "K4 interior_stencil", label,
                device_ms(lambda: k4.interior_stencil(xs, taps),
                          "interior_sweep_kernel", 20),
                time_ms(lambda: k4.interior_stencil_plain(xs, taps), 3),
                K4_BYTES_PER_NODE * nodes, k4_flops, conv_ms),
            "g2": report_time(
                "G2 keff_boundary", label,
                device_ms(lambda: g2.keff_boundary(model, interior, x, m_ss, m_mf),
                          "keff_boundary_kernel", 20),
                time_ms(lambda: g2.keff_boundary_plain(
                    model, interior, x, m_ss, m_mf), 3),
                g2_bytes, g2_flops),
        }
        timing[label]["k4"]["call_ms"] = k4_call
        timing[label]["g2"]["call_ms"] = g2_call
        split_ms = time_ms(
            lambda: tops.apply_keff_split_structured(model, x, m_ss, m_mf), 50)
        k1_ms = time_ms(lambda: k12.apply_keff_fused(model, x, m_ss, m_mf), 50)
        # every kernel of the split (sanitize, K4, G2) by device events
        split_dev = device_ms(
            lambda: tops.apply_keff_split_structured(model, x, m_ss, m_mf), "", 20)
        k1_dev = device_ms(lambda: k12.apply_keff_fused(model, x, m_ss, m_mf),
                           "keff_sweep_kernel", 20)
        print(f"  K4 per wrapper call {k4_call:.4f} ms, G2 {g2_call:.4f} ms "
              "(CUDA events)", flush=True)
        print(f"  K4 library yardstick conv3d (cuDNN, TF32 off): {conv_ms:.4f} ms, "
              f"max abs diff from the plain K4 {conv_err:.3e} of max|plain|", flush=True)
        print(f"time split operator [{label}]: sanitize + K4 + G2 {split_ms:.4f} ms "
              f"per call ({split_dev:.4f} ms of device time) against K1 "
              f"{k1_ms:.4f} ms ({k1_dev:.4f}) on the same model", flush=True)
        timing[label]["split_ms"], timing[label]["k1_ms"] = split_ms, k1_ms
        timing[label]["split_device_ms"] = split_dev
        timing[label]["k1_device_ms"] = k1_dev
        del model, x, xs, interior, out_g2
        torch.cuda.empty_cache()
    return errs, timing


def column_main_path_phase(device):
    """Phase 12: the slender main path at full width through
    build_simulation, then the K4 route against the K1 route."""
    from civiwave_tpu_torch.ops import structured as tops
    from civiwave_tpu_torch.runner import build_simulation
    from civiwave_tpu_torch.utils.synthetic import soil_column_config

    cfg = soil_column_config(cells=COLUMN)
    t0 = time.perf_counter()
    sim = build_simulation(cfg, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = sim.model
    grid = tuple(n + 1 for n in COLUMN)
    if model.grid_shape != grid or model.dof_count != 3 * int(np.prod(grid)):
        fail(f"soil column: {model.dof_count:,} DOF on {model.grid_shape}")
    if not tops.slender_route(model, torch.float32) or model.absorb_faces != ("x0",):
        fail("soil column: not on the slender route with an absorbing base")
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    frame_s, telemetries = [], []
    for _ in range(8):
        t0 = time.perf_counter()
        telemetries += sim.run(1)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    counts = all_counts()
    peak = torch.cuda.max_memory_allocated()
    iters = [t.pcg_iterations for t in telemetries]
    if not all(t.pcg_converged for t in telemetries):
        fail(f"soil column: not every frame converged: {iters}")
    state = sim.stepper.state
    for name in ("displacement", "velocity", "acceleration"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            fail(f"soil column: non-finite {name}")
    # classic PCG: each frame's Rayleigh-beta and residual matvecs, then one
    # per iteration
    matvecs = sum(iters) + 2 * len(iters)
    if counts["k4"] != matvecs or counts["g2"] != matvecs:
        fail(f"soil column: K4/G2 launched {counts['k4']}/{counts['g2']} "
             f"times for {matvecs} matvecs")
    if counts["keff"] or counts["pc"] or counts["k6"] or counts["bj"] <= 0:
        fail(f"soil column: wrong kernels on the slender route {counts}")
    base_uy = float(state.displacement[1, 0].abs().max())
    if not base_uy > 0.0:
        fail("soil column: the base did not move under the shear pulse")
    steady = frame_s[1:]
    print(f"soil column: {model.dof_count:,} DOF, grid {model.grid_shape}, "
          f"model build {build_s:.3f} s", flush=True)
    print(f"soil column: pcg iterations per frame {iters} (classic)", flush=True)
    print("soil column: frame seconds " + ", ".join(f"{t:.4f}" for t in frame_s),
          flush=True)
    summary = dict(iters=iters, steps_per_s=len(steady) / sum(steady),
                   ms_per_iter=sum(steady) / sum(iters[1:]) * 1e3, peak=peak,
                   u=state.displacement.cpu(), a=state.acceleration.cpu())
    print(f"soil column: steps/s {summary['steps_per_s']:.4f} (frames 2-8), "
          f"{summary['ms_per_iter']:.4f} ms per iteration (host clock)", flush=True)
    print(f"soil column: peak device memory {peak / 2**30:.3f} GiB ({peak} bytes)",
          flush=True)
    print(f"soil column: kernel launches {counts} for {matvecs} matvecs; base "
          f"max |u_y| {base_uy:.6e} m", flush=True)
    profile_window("soil column frame 9", lambda: sim.run(1))
    del sim, model, state
    torch.cuda.empty_cache()

    # the K4 route against the K1 route, 3 classic frames each
    runs = {}
    saved = tops._FLAT_INTERIOR_NODE_THRESHOLD
    for route in ("split", "k1"):
        if route == "k1":  # every grid takes K1 again
            tops._FLAT_INTERIOR_NODE_THRESHOLD = 1 << 62
        try:
            sim = build_simulation(cfg, device=device)
            sim.stepper.solver_variant = "classic"
            reset_all_counts()
            tel = sim.run(3)
            runs[route] = (tel, sim.stepper.state, all_counts())
        finally:
            tops._FLAT_INTERIOR_NODE_THRESHOLD = saved
        del sim
    (ts, state_s, cs), (tk, state_k, ck) = runs["split"], runs["k1"]
    if cs["k4"] <= 0 or cs["keff"] or ck["k4"] or ck["keff"] <= 0:
        fail(f"soil column routes: split {cs}, k1 {ck}")
    it_s = [t.pcg_iterations for t in ts]
    it_k = [t.pcg_iterations for t in tk]
    if any(abs(a - b) > 1 for a, b in zip(it_s, it_k)):
        fail(f"soil column routes: iterations {it_s} vs {it_k}")
    if not all(t.pcg_converged for t in ts + tk):
        fail("soil column routes: a frame did not converge")
    errs = {}
    for name, tol in (("displacement", U_TOL), ("acceleration", A_TOL)):
        _, errs[name] = check_close(f"soil column routes {name}",
                                    getattr(state_s, name),
                                    getattr(state_k, name), tol)
    print(f"soil column K4 route vs K1 route, 3 classic frames: iterations "
          f"{it_s} vs {it_k}; max abs err / max|K1 run| u "
          f"{errs['displacement']:.3e} (tol {U_TOL:g}), a "
          f"{errs['acceleration']:.3e} (tol {A_TOL:g})", flush=True)
    del runs, state_s, state_k
    torch.cuda.empty_cache()
    return counts, summary


def basin_phase(device):
    """Phase 13: examples/seismic_basin.yaml GPU against CPU, then the
    basin at 255^3 on the GPU."""
    from civiwave_tpu_torch.config.loader import load_config_from_file
    from civiwave_tpu_torch.runner import build_simulation

    runs = {}
    for dev in (device, "cpu"):
        sim = build_simulation(BASIN, device=dev)
        reset_all_counts()
        tel = sim.run(10)
        runs[str(dev)] = (tel, sim.stepper.state, all_counts())
    (tg, sg, counts), (tc, sc, _) = runs[str(device)], runs["cpu"]
    it_g = [t.pcg_iterations for t in tg]
    it_c = [t.pcg_iterations for t in tc]
    if any(abs(a - b) > 1 for a, b in zip(it_g, it_c)):
        fail(f"basin: iterations differ by more than 1: {it_g} vs {it_c}")
    if not all(t.pcg_converged for t in tg):
        fail(f"basin: GPU frames not all converged: {it_g}")
    if counts["pc"] <= 0 or counts["keff"] <= 0 or counts["k4"] or counts["k6"]:
        fail(f"basin: wrong kernels {counts}")
    errs = {}
    for name, tol in (("displacement", U_TOL), ("acceleration", A_TOL)):
        _, errs[name] = check_close(
            f"basin {name}", getattr(sg, name).cpu(), getattr(sc, name), tol)
    print(f"seismic_basin 10 frames: iterations gpu {it_g} cpu {it_c}; max abs "
          f"err / max|cpu| u {errs['displacement']:.3e} (tol {U_TOL:g}), a "
          f"{errs['acceleration']:.3e} (tol {A_TOL:g}); gpu launches {counts}",
          flush=True)
    del runs, sg, sc

    cfg = dataclasses.replace(load_config_from_file(BASIN),
                              mesh_path="synthetic://box/%d,%d,%d" % FULL)
    sim = build_simulation(cfg, device=device)
    reset_all_counts()
    frame_s, tel = [], []
    for _ in range(4):
        t0 = time.perf_counter()
        tel += sim.run(1)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    counts = all_counts()
    iters = [t.pcg_iterations for t in tel]
    if not all(t.pcg_converged for t in tel) or sum(iters[1:]) <= 0:
        fail(f"basin 255^3: frames {iters} not all converged with load")
    if not bool(torch.isfinite(sim.stepper.state.displacement).all()):
        fail("basin 255^3: non-finite displacement")
    if counts["pc"] <= 0 or counts["keff"] <= 0 or counts["k4"] or counts["k6"]:
        fail(f"basin 255^3: wrong kernels {counts}")
    print(f"seismic_basin at 255^3 ({sim.model.dof_count:,} DOF, five absorbing "
          f"faces): pcg iterations {iters}, frame seconds " + ", ".join(
              f"{t:.4f}" for t in frame_s) + f"; steps/s {3 / sum(frame_s[1:]):.4f} "
          f"(frames 2-4); launches {counts}", flush=True)
    # the 4 frames' result, off the card, for phase 26's sharded basin
    full = dict(iters=iters, steps_per_s=3 / sum(frame_s[1:]),
                u=sim.stepper.state.displacement.cpu(),
                a=sim.stepper.state.acceleration.cpu())
    del sim
    torch.cuda.empty_cache()
    return full


# phase 14's grids: (label, cells, (npx, npy), 2-D, timing key); the
# reference's own (tests/test_sharding.py:183-185, :585-586) and the 255^3
# cuts, timed on an inner 64-plane slab and on the main path's whole slab
HALO_GRIDS = [
    ("6x3x3 over 8 (Xl 1)", (6, 3, 3), (8, 1), False, None),
    ("15x4x4 over 4 (split)", (15, 4, 4), (4, 1), False, None),
    ("9x4x5 on 2x4 (3 dead +Y rows)", (9, 4, 5), (2, 4), True, None),
    ("7x7x3 on 2x2", (7, 7, 3), (2, 2), True, None),
    ("255^3 over 4 (Xl 64)", FULL, (4, 1), False, "slab64"),
    ("255^3 on 2x2 (128x128 tiles)", FULL, (2, 2), True, None),
    ("255^3 whole slab", FULL, (1, 1), False, "slab256"),
]
K5_GHOST_BYTES_PER_NODE = 15  # a ghost node's 3 f32 values and 3 mask bytes


def halo_tiles(model, x, shape, two_d):
    """(tile model with its mask ghosts, x block, x ghosts, offsets) per
    tile of a (npx, npy) cut, without a process group: the ghosts a shard
    would receive, cut from the global arrays."""
    from civiwave_tpu_torch.ops.structured_sharded import cut_ghosts
    from civiwave_tpu_torch.parallel import sharding

    out = []
    for local in sharding.local_tiles(model, shape, two_d):
        x0, y0, (xl, yl) = local.x0, local.y0, local.local_extent
        out.append((local, sharding.cut_block(x, x0, y0, xl, yl),
                    cut_ghosts(x, x0, y0, xl, yl, two_d), (x0, y0, xl, yl)))
    return out


def split_keff(local, xt, ghosts, ss, mf):
    """The overlap split's three K5 launches (the library's own)."""
    from civiwave_tpu_torch.ops.structured_sharded import local_keff

    os.environ["CIVIWAVE_HALO_OVERLAP"] = "1"
    try:
        return local_keff(local, xt, ghosts, ss, mf)
    finally:
        os.environ.pop("CIVIWAVE_HALO_OVERLAP", None)


def k5_least(local):
    """K5's (least bytes, least f32 operations) on one shard: K1's per node
    plus each ghost node's values and mask once."""
    xl, yl, z = local.grid_shape
    ghost_nodes = 2 * (yl + 2 * int(local.bc_ghosts.y_lo is not None)) * z
    if local.bc_ghosts.y_lo is not None:
        ghost_nodes += 2 * xl * z
    nodes = xl * yl * z
    return (KERNEL_BYTES_PER_NODE["keff"] * nodes
            + K5_GHOST_BYTES_PER_NODE * ghost_nodes,
            KERNEL_FLOPS_PER_NODE["keff"] * nodes)


def halo_kernel_phase(device, ss, mf):
    """Phase 14: K5 against its plain version on every tile, the gathered
    tiles against K1 on the whole grid, the overlap split's three launches
    against one launch, and K5's times beside K1's on the same nodes."""
    from civiwave_tpu_torch.mesh.structured import build_structured_model
    from civiwave_tpu_torch.ops.cuda import keff_halo as k5
    from civiwave_tpu_torch.ops.cuda import structured_stencil as k12
    from civiwave_tpu_torch.physics import materials
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    mat = cantilever_config().materials[0]
    props = materials.make_properties(mat)
    rng = np.random.default_rng(SEED + 14)
    worst = (0.0, 0.0)
    timing = {}
    for label, cells, shape, two_d, key in HALO_GRIDS:
        model, _ = build_structured_model(
            *cells, props, mat.density, device=device,
            pad_x_multiple=shape[0], pad_y_multiple=shape[1] if two_d else 1,
        )
        x = torch.as_tensor(rng.standard_normal(model.vector_shape,
                                                dtype=np.float32), device=device)
        gathered = torch.empty_like(x)
        errs = []
        tiles = halo_tiles(model, x, shape, two_d)
        for local, xt, ghosts, (x0, y0, xl, yl) in tiles:
            out = k5.keff_structured_halo(local, xt, ghosts, ss, mf)
            errs.append(check_close(
                f"K5 {label} tile ({x0}, {y0})", out,
                k5.keff_structured_halo_plain(local, xt, ghosts, ss, mf), OP_TOL))
            if xl >= 4:  # the overlap split: interior first, reading no X ghost
                if not torch.equal(split_keff(local, xt, ghosts, ss, mf), out):
                    fail(f"K5 {label}: the overlap split differs from one launch")
            gathered[:, x0:x0 + xl, y0:y0 + yl] = out
        k1 = k12.apply_keff_fused(model, x, ss, mf)
        if not torch.equal(gathered, k1):  # one sweep, global classes
            fail(f"K5 {label}: the gathered tiles differ from K1 "
                 f"({int((gathered != k1).sum()):,} values)")
        del k1
        rel = max(r for _, r in errs)
        worst = max(worst, *errs, key=lambda e: e[1])
        print(f"K5 [{label}]: {len(tiles)} tiles, vs plain max rel err "
              f"{rel:.2e}, gathered vs K1 bit-equal", flush=True)
        if key is not None:
            # an inner slab (both X ghosts real) or the whole grid
            local, xt, ghosts, _ = tiles[min(1, len(tiles) - 1)]
            xl = local.grid_shape[0]
            same, _ = build_structured_model(
                xl - 1, *cells[1:], props, mat.density, device=device)
            xk1 = xt.clone()
            ms = time_ms(lambda: k5.keff_structured_halo(
                local, xt, ghosts, ss, mf), 20)
            split_ms = time_ms(lambda: split_keff(local, xt, ghosts, ss, mf), 20)
            k1_ms = time_ms(lambda: k12.apply_keff_fused(same, xk1, ss, mf), 20)
            plain_ms = time_ms(lambda: k5.keff_structured_halo_plain(
                local, xt, ghosts, ss, mf), 3)
            least, flops = k5_least(local)
            bound_ms, bound_by = bound(least, flops)
            timing[key] = dict(ms=ms, split_ms=split_ms, k1_ms=k1_ms,
                               plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by)
            print(f"time K5 {key} {tuple(local.grid_shape)}: kernel {ms:.4f} ms "
                  f"(overlap split, 3 launches, {split_ms:.4f} ms), K1 on the "
                  f"same nodes {k1_ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
                  f"{bound_ms:.4f} ms by {bound_by} ({least / 1e9:.4f} GB), "
                  f"{least / 1e9 / ms:.3f} TB/s", flush=True)
            del same, xk1
        del model, x, gathered, tiles
        torch.cuda.empty_cache()
    return worst, timing


def sharded_counts():
    """K5/K3/K1/K2/K6 launches and the collectives' calls."""
    from civiwave_tpu_torch.parallel import collectives

    return {**structured_counts(), "ppermute": collectives.ppermute.calls,
            "psum": collectives.psum.calls,
            "psum_f64_3": collectives.psum.shapes[(torch.float64, (3,))],
            "psum_f64_4": collectives.psum.shapes[(torch.float64, (4,))]}


def reset_sharded_counts():
    from civiwave_tpu_torch.parallel import collectives

    reset_structured_counts()
    collectives.reset_counts()


def check_sharded_counts(label, counts, iters, per_matvec, exchanges):
    """Every sharded frame: the Rayleigh, residual and setup matvecs, then
    one per fused iteration; K5 ``per_matvec`` times each, K3 once per
    iteration and setup; one f64 (3,) all-reduce per iteration."""
    frames, total = len(iters), sum(iters)
    matvecs = 3 * frames + total
    want = {"k5": per_matvec * matvecs, "bj": total + frames, "keff": 0,
            "pc": 0, "k6": 0, "ppermute": exchanges * matvecs,
            "psum": total + frames, "psum_f64_3": total, "psum_f64_4": frames}
    if counts != want:
        fail(f"{label}: counts {counts}, expected {want}")


def sharded_main_path_phase(device, split):
    """Phase 15: the sharded main path at full width over one-rank NCCL
    groups, against phase 4's unsharded fused frames."""
    from civiwave_tpu_torch.parallel.sharding import (
        close_shard_group,
        make_shard_group,
        make_shard_group_2d,
        shard_simulation,
    )
    from civiwave_tpu_torch.runner import build_simulation
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    cfg = cantilever_config(
        tol_runtime=2e-4, max_iters=120, dt=1e-3, adaptive=False,
        mesh={"path": "synthetic://box/%d,%d,%d" % FULL},
    )
    sim = shard_simulation(build_simulation(cfg, device=device),
                           make_shard_group(1, device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_sharded_counts()
    frame_s, tel = [], []
    for _ in range(8):
        t0 = time.perf_counter()
        tel += sim.run(1)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        if len(tel) == 3:  # for the 3-frame runs below, off the card
            third = dict(u=sim.stepper.state.displacement.cpu(),
                         a=sim.stepper.state.acceleration.cpu())
    counts = sharded_counts()
    peak = torch.cuda.max_memory_allocated()
    iters = [t.pcg_iterations for t in tel]
    if not all(t.pcg_converged for t in tel):
        fail(f"sharded main path: not every frame converged: {iters}")
    if any(abs(a - b) > 1 for a, b in zip(iters, split["iters"])):
        fail(f"sharded main path: iterations {iters} not within 1 of the "
             f"unsharded fused frames' {split['iters']}")
    check_sharded_counts("sharded main path", counts, iters, 3, 2)
    state = sim.stepper.state
    errs = {}
    for name, key, tol in (("displacement", "u", U_TOL),
                           ("acceleration", "a", A_TOL)):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            fail(f"sharded main path: non-finite {name}")
        _, errs[key] = check_close(f"sharded main path {name}",
                                   getattr(state, name).cpu(), split[key], tol)
    steady = frame_s[1:]
    summary = dict(iters=iters, counts=counts, peak=peak,
                   steps_per_s=len(steady) / sum(steady),
                   ms_per_iter=sum(steady) / sum(iters[1:]) * 1e3)
    print(f"sharded main path (1-D, one rank, overlap split): pcg iterations "
          f"{iters} (unsharded fused {split['iters']}); max abs err / max|ref| "
          f"u {errs['u']:.3e} (tol {U_TOL:g}), a {errs['a']:.3e} (tol {A_TOL:g})",
          flush=True)
    print("sharded main path: frame seconds " + ", ".join(
        f"{t:.4f}" for t in frame_s), flush=True)
    print(f"sharded main path: steps/s {summary['steps_per_s']:.4f} (frames 2-8; "
          f"unsharded fused {split['steps_per_s']:.4f}), {summary['ms_per_iter']:.4f} "
          f"ms per iteration (unsharded fused {split['ms_per_iter']:.4f}); peak "
          f"device memory {peak / 2**30:.3f} GiB ({peak} bytes)", flush=True)
    print(f"sharded main path: counts {counts}", flush=True)
    profile_window("sharded main path frame 9", lambda: sim.run(1))
    del sim, state
    torch.cuda.empty_cache()

    # 3 frames over a one-rank 2-D group (the ghost-Y form), then 3 on the
    # 1-D group without the overlap split
    for label, make, per_matvec, exchanges, overlap in (
        ("2-D ghost-Y form", lambda: make_shard_group_2d(1, 1, device), 3, 4, "1"),
        ("1-D without the split", lambda: make_shard_group(1, device), 1, 2, "0"),
    ):
        os.environ["CIVIWAVE_HALO_OVERLAP"] = overlap
        try:
            sim = shard_simulation(build_simulation(cfg, device=device), make())
            reset_sharded_counts()
            tel3 = sim.run(3)
            counts3 = sharded_counts()
        finally:
            os.environ.pop("CIVIWAVE_HALO_OVERLAP", None)
        it3 = [t.pcg_iterations for t in tel3]
        if not all(t.pcg_converged for t in tel3) or any(
                abs(a - b) > 1 for a, b in zip(it3, iters)):
            fail(f"sharded {label}: iterations {it3} vs {iters[:3]}")
        check_sharded_counts(f"sharded {label}", counts3, it3, per_matvec,
                             exchanges)
        state = sim.stepper.state
        e = {}
        for name, key, tol in (("displacement", "u", U_TOL),
                               ("acceleration", "a", A_TOL)):
            _, e[key] = check_close(f"sharded {label} {name}",
                                    getattr(state, name).cpu(), third[key], tol)
        print(f"sharded {label}, 3 frames: iterations {it3}; max abs err / "
              f"max|1-D run| u {e['u']:.3e}, a {e['a']:.3e}; counts {counts3}",
              flush=True)
        del sim, state
        torch.cuda.empty_cache()
    close_shard_group()
    return summary


# --- static mode and output (phases 16-17) -----------------------------------

STATIC_YAML = "examples/static_cantilever.yaml"
BOX_YAML = "examples/cantilever_box.yaml"
# Euler-Bernoulli + Timoshenko tip deflection of the static example (a copy
# of tests/test_validation_analytic.py's formula): 3 x 1 x 1 m steel beam,
# -1e6 Pa end traction
BEAM = dict(length=3.0, width=1.0, depth=1.0, e_mod=2.0e11, nu=0.3, traction=-1.0e6)
TET_BASIN = (80, 80, 40)  # 1,536,000 tets, 269,001 nodes, 807,003 DOF
# PCG cap of the 255^3 static solves: classic needs ~2,800 iterations to
# 1e-8 there, the fused and megafused recurrences ~4,100 and ~4,400
STATIC_MAX_ITERS = 6000


def beam_theory_deflection(length, width, depth, e_mod, nu, traction):
    area = width * depth
    load = traction * area
    inertia = width * depth ** 3 / 12.0
    g_mod = e_mod / (2.0 * (1.0 + nu))
    k_shear = 10.0 * (1.0 + nu) / (12.0 + 11.0 * nu)
    return (load * length ** 3 / (3.0 * e_mod * inertia)
            + load * length / (k_shear * g_mod * area))


def scratch_dir(label):
    """A fresh directory under the port's build directory (ignored by git),
    for output files that are read back and removed."""
    import tempfile

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "civiwave_tpu_torch", "_build")
    os.makedirs(root, exist_ok=True)
    return tempfile.mkdtemp(prefix=f"smoke_{label}_", dir=root)


def read_vtu(path, names=None):
    """(header text, {name: f32 array}) of a VTU's appended Float32 point and
    cell arrays (``names``: only these), reading each block by seeking to
    its offset."""
    import re

    with open(path, "rb") as f:
        head = b""
        while b'<AppendedData encoding="raw">\n_' not in head:
            chunk = f.read(1 << 16)
            if not chunk:
                fail(f"{path}: no appended data")
            head += chunk
        start = head.index(b'<AppendedData encoding="raw">\n_') + len(
            b'<AppendedData encoding="raw">\n_')
        header = head[:start].decode("ascii")
        arrays = {}
        for m in re.finditer(r'type="Float32" Name="(\w+)"[^>]*offset="(\d+)"',
                             header):
            if names is not None and m.group(1) not in names:
                continue
            f.seek(start + int(m.group(2)))
            size = int(np.frombuffer(f.read(4), np.uint32)[0])
            arrays[m.group(1)] = np.frombuffer(f.read(size), np.float32)
    return header, arrays


def direct_static_solution(sim):
    """The static example's exact f64 solution on the host: the dense
    oracle's assembly and Dirichlet rows (physics/oracle.py) solved by a
    sparse direct solve (the oracle's own diagonal CG does not reach its
    tolerance on this slender 11k-DOF beam within 20,000 iterations)."""
    import scipy.sparse
    import scipy.sparse.linalg

    from civiwave_tpu_torch.physics import loads, materials, oracle

    sim.ensure_host_mesh()
    mats = [materials.make_properties(m) for m in sim.config.materials]
    assembly = oracle.assemble_linear_system(sim.mesh, sim.preprocess, mats)
    f = loads.assemble_load_vector(sim.mesh, sim.config, sim.preprocess,
                                   0.0).reshape(-1).astype(np.float64)
    k = assembly.stiffness.copy()
    oracle.apply_dirichlet(k, f, oracle.build_dirichlet_conditions(
        sim.mesh, sim.config), None)
    return scipy.sparse.linalg.spsolve(scipy.sparse.csr_matrix(k), f).reshape(-1, 3)


def check_rows(label, got, ref, tol):
    """max|got - ref| <= tol * max|ref| on host arrays; returns the ratio."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    if not math.isfinite(err) or err > tol * scale + 1e-30:
        fail(f"{label}: max abs err {err:.3e} > {tol:g} * max|ref| {scale:.3e}")
    return err / max(scale, 1e-300)


def static_example_phase(device):
    """Phase 16a-b: examples/static_cantilever.yaml through the CLI with
    --static --output on the GPU and the CPU (structured route), then the
    same beam meshed with tets through run_static (general path)."""
    import shutil

    from civiwave_tpu_torch.config.loader import load_config_from_file
    from civiwave_tpu_torch.runner import build_simulation, main as cli, run_static
    from civiwave_tpu_torch.solver.static import true_relative_residual

    tmp = scratch_dir("static_example")
    runs = {}
    try:
        for side, dev in (("gpu", device), ("cpu", torch.device("cpu"))):
            out = os.path.join(tmp, side)
            tel = os.path.join(tmp, f"{side}.json")
            reset_structured_counts()
            t0 = time.perf_counter()
            rc = cli([STATIC_YAML, "--static", "--output", out, "--quiet",
                      "--telemetry-json", tel, "--device", str(dev)])
            if dev.type == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if rc != 0:
                fail(f"static example on {dev}: exit code {rc}")
            with open(tel, encoding="utf-8") as f:
                payload = json.load(f)
            _, arrays = read_vtu(os.path.join(out, "vtu", "frame_00000.vtu"))
            runs[side] = (payload, arrays, seconds, structured_counts())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (pg, ag, sg, counts), (pc, ac, sc, _) = runs["gpu"], runs["cpu"]
    if not (pg["converged"] and pc["converged"]):
        fail("static example: not converged")
    if counts["pc"] <= 0 or counts["keff"] <= 0:
        fail(f"static example on the GPU: fused kernels not launched {counts}")
    if sorted(ag) != sorted(ac):
        fail(f"static example: VTU arrays differ {sorted(ag)} vs {sorted(ac)}")
    vtu_err = {name: check_rows(f"static example VTU {name}", ag[name], ac[name],
                                U_TOL if name == "displacement" else A_TOL)
               for name in ag}
    ug = ag["displacement"].reshape(-1, 3)
    uc = ac["displacement"].reshape(-1, 3)
    sim = build_simulation(STATIC_YAML, device=device)
    exact = direct_static_solution(sim)
    oracle_err = {k: check_rows(f"static example {k} vs the direct f64 solve",
                                u, exact, U_TOL)
                  for k, u in (("gpu", ug), ("cpu", uc))}
    tip = float(ug.reshape(31, 11, 11, 3)[30, :, :, 2].mean())
    analytic = beam_theory_deflection(**BEAM)
    if abs(tip - analytic) > 0.10 * abs(analytic):
        fail(f"static example: tip {tip:.6e} not within 10 % of beam theory "
             f"{analytic:.6e}")
    res = true_relative_residual(sim.model, sim.stepper.external_force,
                                 sim.model.from_nodal(ug))
    print(f"static example (30x10x10 hex, 11,253 DOF): iterations gpu {pg['iterations']} "
          f"(auto = fused) cpu {pc['iterations']} (classic); CLI seconds gpu "
          f"{sg:.3f} cpu {sc:.3f}, solve seconds gpu {pg['elapsed_seconds']:.4f} "
          f"cpu {pc['elapsed_seconds']:.4f}; true relative residual (f64) gpu "
          f"{res:.3e}; gpu launches {counts}", flush=True)
    print(f"static example: u gpu vs cpu (VTU) {vtu_err['displacement']:.3e} of "
          f"max|u|, worst other array {max(vtu_err.values()):.3e}; vs the direct "
          f"f64 solve gpu {oracle_err['gpu']:.3e} cpu {oracle_err['cpu']:.3e} (tol "
          f"{U_TOL:g}); tip u_z {tip:.6e} m, beam theory {analytic:.6e} m "
          f"({(tip - analytic) / analytic:+.4f})", flush=True)
    del sim

    cfg = dataclasses.replace(load_config_from_file(STATIC_YAML),
                              mesh_path="synthetic://box/30,10,10,tet,0.1")
    gen = {}
    for side, dev in (("gpu", device), ("cpu", torch.device("cpu"))):
        sim = build_simulation(cfg, device=dev)
        reset_general_counts()
        t0 = time.perf_counter()
        u, payload = run_static(sim)
        seconds = time.perf_counter() - t0
        gen[side] = (sim.stepper.displacement(), payload, seconds,
                         general_counts(),
                         true_relative_residual(sim.model, sim.stepper.external_force, u))
        del sim
    (ug, pg, sg, counts, rg), (uc, pc, sc, _, rc_) = gen["gpu"], gen["cpu"]
    if not (pg["converged"] and pc["converged"]):
        fail("static tet beam: not converged")
    if counts["element_forces_tet"] <= 0 or counts["assemble_csr"] <= 0:
        fail(f"static tet beam: K7 tet / G1 not launched {counts}")
    err = check_rows("static tet beam u gpu vs cpu", ug, uc, U_TOL)
    print(f"static tet beam (general path, {ug.shape[0] * 3:,} DOF): iterations gpu "
          f"{pg['iterations']} cpu {pc['iterations']} (classic both); seconds gpu "
          f"{sg:.3f} cpu {sc:.3f}; true relative residual gpu {rg:.3e} cpu "
          f"{rc_:.3e}; u gpu vs cpu {err:.3e} of max|u|; gpu launches {counts}",
          flush=True)
    return counts


def static_full_width_phase(device):
    """Phase 16c: the 255^3 steel cantilever (50,331,648 DOF) solved
    statically three times through build_simulation and run_static: 'auto'
    (fused, K2; writes VTU frame 0), 'classic' (K1 + K3) and the K6 loop
    (CIVIWAVE_MEGA_PCG=1 for that run only).  The cap is STATIC_MAX_ITERS,
    not the example's 4000: the Chronopoulos-Gear recurrences need more
    iterations than classic PCG to reach 1e-8 in f32 vectors (PERF.md §6),
    and the check is that each converges."""
    import shutil

    from civiwave_tpu_torch.runner import build_simulation, run_static
    from civiwave_tpu_torch.solver.static import true_relative_residual
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    cfg = cantilever_config(max_iters=STATIC_MAX_ITERS,
                            mesh={"path": "synthetic://box/%d,%d,%d" % FULL})
    tmp = scratch_dir("static_255")
    results = {}
    try:
        t0 = time.perf_counter()
        sim = build_simulation(cfg, device=device, output_root=tmp)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        model = sim.model
        for label, variant, mega in (("fused", "auto", False),
                                     ("classic", "classic", False),
                                     ("megafused", "fused", True)):
            if mega:
                os.environ[MEGA] = "1"
            try:
                torch.cuda.reset_peak_memory_stats()
                reset_structured_counts()
                t0 = time.perf_counter()
                u, payload = run_static(sim, variant=variant)
                torch.cuda.synchronize()
                total = time.perf_counter() - t0
                counts = structured_counts()
                peak = torch.cuda.max_memory_allocated()
            finally:
                os.environ.pop(MEGA, None)
            if not payload["converged"]:
                fail(f"static 255^3 {label}: not converged in "
                     f"{payload['iterations']} iterations (residual "
                     f"{payload['residual_norm']:.3e}, rhs {payload['rhs_norm']:.3e})")
            if not bool(torch.isfinite(u).all()):
                fail(f"static 255^3 {label}: non-finite u")
            res = true_relative_residual(model, sim.stepper.external_force, u)
            results[label] = dict(u=u.clone(), payload=payload, total=total,
                                  counts=counts, peak=peak, res=res)
            if sim.output is not None:  # frame 0 of the first run only
                vtu_s = total - payload["elapsed_seconds"]
                sim.output = None
            print(f"static 255^3 {label}: {payload['iterations']} iterations in "
                  f"{payload['elapsed_seconds']:.4f} s ({payload['elapsed_seconds'] / max(payload['iterations'], 1) * 1e3:.4f} "
                  f"ms per iteration), recurred residual {payload['residual_norm']:.3e} "
                  f"of rhs {payload['rhs_norm']:.3e}, true relative residual (f64) "
                  f"{res:.3e}, peak device memory {peak / 2**30:.3f} GiB, launches "
                  f"{counts}", flush=True)
        fused, classic, megaf = (results[k] for k in ("fused", "classic", "megafused"))
        if fused["counts"]["pc"] <= 0 or fused["counts"]["k6"] or \
                classic["counts"]["bj"] <= 0 or classic["counts"]["pc"] or \
                megaf["counts"]["k6"] != megaf["payload"]["iterations"]:
            fail("static 255^3: wrong kernels " + str(
                {k: r["counts"] for k, r in results.items()}))
        # the exact solution to f64 accuracy: classic's u refined twice
        t0 = time.perf_counter()
        exact, steps = refined_static_solution(sim, classic["u"])
        refine_s = time.perf_counter() - t0
        umax = float(exact.abs().max())
        for r in results.values():
            r["err"] = float((r["u"].double() - exact).abs().max()) / umax
        if not classic["err"] <= U_TOL:
            fail(f"static 255^3 classic: u differs from the refined f64 solution "
                 f"by {classic['err']:.3e} > {U_TOL:g} of max|u|")
        # fused and megafused run one recurrence: they must agree
        rec = float((fused["u"] - megaf["u"]).abs().max()) / umax
        if not rec <= U_TOL:
            fail(f"static 255^3: fused and megafused u differ by {rec:.3e} > "
                 f"{U_TOL:g} of max|u|")
        it = {k: r["payload"]["iterations"] for k, r in results.items()}
        print(f"static 255^3: iterations {it}; fused / classic "
              f"{it['fused'] / it['classic']:.4f}, megafused / classic "
              f"{it['megafused'] / it['classic']:.4f}", flush=True)
        print(f"static 255^3: u against classic's u refined twice in f64 (" +
              ", ".join(f"{s_:.3e}" for s_ in steps) + f" relative f64 residual "
              f"before each step, {refine_s:.3f} s): classic {classic['err']:.3e}, "
              f"fused {fused['err']:.3e}, megafused {megaf['err']:.3e} of max|u| "
              f"{umax:.6e} m (tol {U_TOL:g}; the Chronopoulos-Gear recurrences "
              f"stop on a recurred residual of 1e-8 while their u is off by the "
              f"residual gap, PERF.md §6); fused vs megafused {rec:.3e}",
              flush=True)

        path = os.path.join(tmp, "vtu", "frame_00000.vtu")
        size = os.path.getsize(path)
        header, arrays = read_vtu(path, names=("displacement",))
        n = model.node_count
        if f'NumberOfPoints="{n}"' not in header or \
                f'NumberOfCells="{model.nx * model.ny * model.nz}"' not in header:
            fail("static 255^3 VTU: wrong piece counts")
        disp = arrays["displacement"]
        u_max = float(model.to_nodal(fused["u"]).abs().max())
        if disp.size != 3 * n or float(np.abs(disp).max()) != u_max:
            fail(f"static 255^3 VTU: displacement block max {np.abs(disp).max()} "
                 f"!= max|u| {u_max}")
        print(f"static 255^3 VTU frame 0: {size:,} bytes, {vtu_s:.3f} s for the "
              f"derived fields, host transfers and the write (writer "
              f"{'native' if native_writer() else 'numpy'}); displacement block "
              f"max {float(np.abs(disp).max()):.6e} = max|u|; model build "
              f"{build_s:.3f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = {k: dict(iterations=r["payload"]["iterations"],
                       seconds=r["payload"]["elapsed_seconds"], counts=r["counts"],
                       res=r["res"], err=r["err"]) for k, r in results.items()}
    summary["vtu"] = dict(bytes=size, seconds=vtu_s)
    summary["exact"] = exact  # f64 on the card, for phases 18 and 19
    del sim, model, results, fused, classic, megaf
    torch.cuda.empty_cache()
    return summary


def refined_static_solution(sim, u, steps=2):
    """The static solution to f64 accuracy by mixed-precision iterative
    refinement of ``u``: the residual f - K x in f64 (the plain operator),
    a classic f32 PCG solve of K d = r (K1 + K3, to 1e-8 of |r|), x += d,
    ``steps`` times.  Returns (x in f64, the relative f64 residual before
    each step)."""
    from civiwave_tpu_torch.ops.structured import apply_keff_structured_plain
    from civiwave_tpu_torch.solver.pcg import solve_pcg

    model, force = sim.model, sim.stepper.external_force
    f64 = torch.float64
    rhs = torch.where(model.bc_mask, model.bc_value.to(f64), force.to(f64))
    one, zero = np.float32(1.0), np.float32(0.0)
    pc = model.build_preconditioner(one, zero)
    x = u.to(f64)
    rel = []
    for _ in range(steps):
        r = torch.where(model.bc_mask, 0.0,
                        rhs - apply_keff_structured_plain(model, x, 1.0, 0.0))
        rel.append(float(r.norm() / rhs.norm()))
        d, _ = solve_pcg(model, r.float(), one, zero, 1e-8,
                         sim.config.solver.max_iterations, torch.zeros_like(u),
                         warm_start=False, preconditioner=pc, variant="classic")
        x += d.to(f64)
    return x, rel


def native_writer() -> bool:
    from civiwave_tpu_torch.post import native_vtu

    return native_vtu.available()


def probe_table(path):
    with open(path, encoding="ascii") as f:
        rows = [line.strip().split(",") for line in f if line.strip()]
    return rows[0], np.array(rows[1:], dtype=np.float64)


def check_probe_tables(label, got, ref):
    """Probe CSV rows: frame/time/node equal, u at U_TOL and v, a, strain,
    stress and von Mises at A_TOL of each group's max|ref|."""
    if got[0] != ref[0] or got[1].shape != ref[1].shape:
        fail(f"{label}: probe tables differ in shape {got[1].shape} vs {ref[1].shape}")
    g, r = got[1], ref[1]
    if not np.array_equal(g[:, [0, 2]], r[:, [0, 2]]) or not np.allclose(
            g[:, 1], r[:, 1], rtol=1e-12, atol=0):
        fail(f"{label}: probe frame/time/node columns differ")
    return max(check_rows(f"{label} probes u", g[:, 3:6], r[:, 3:6], U_TOL),
               check_rows(f"{label} probes v, a, strain, stress",
                          g[:, 6:], r[:, 6:], A_TOL))


def box_output_phase(device):
    """Phase 17a: examples/cantilever_box.yaml --output for 10 frames
    through the CLI on the GPU and the CPU."""
    import shutil

    from civiwave_tpu_torch.runner import main as cli

    tmp = scratch_dir("box_output")
    out = {}
    try:
        for side, dev in (("gpu", device), ("cpu", torch.device("cpu"))):
            root = os.path.join(tmp, side)
            if cli([BOX_YAML, "--frames", "10", "--quiet", "--device", str(dev),
                    "--output", root]) != 0:
                fail(f"cantilever_box --output on {dev}: non-zero exit")
            frames = sorted(os.listdir(os.path.join(root, "vtu")))
            out[side] = (
                frames, probe_table(os.path.join(root, "probes", "probes.csv")),
                {f: read_vtu(os.path.join(root, "vtu", f))[1] for f in frames})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (fg, tg, vg), (fc, tc, vc) = out["gpu"], out["cpu"]
    if fg != fc or fg != ["frame_00000.vtu", "frame_00005.vtu"]:
        fail(f"cantilever_box --output: VTU frames gpu {fg} cpu {fc}")
    probe_err = check_probe_tables("cantilever_box --output", tg, tc)
    worst = 0.0
    for frame in fg:
        for name in vg[frame]:
            tol = U_TOL if name == "displacement" else A_TOL
            worst = max(worst, check_rows(f"cantilever_box {frame} {name}",
                                          vg[frame][name], vc[frame][name], tol))
    print(f"cantilever_box --output 10 frames: VTU frames {fg} on both; probe rows "
          f"max err / max|cpu| {probe_err:.3e}; VTU arrays worst {worst:.3e} (u at "
          f"{U_TOL:g}, the rest at {A_TOL:g})", flush=True)


def output_255_config(vtu_stride=8):
    """Phase 17b's scenario: the cantilever of ``FULL`` cells with probes on
    the loaded face's corners and at mid-span, a VTU every ``vtu_stride``
    frames."""
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    cells = FULL
    nx, ny, nz = cells
    ys, zs = ny + 1, nz + 1

    def node(i, j, k):
        return (i * ys + j) * zs + k

    probes = [node(nx, 0, 0), node(nx, ny, 0), node(nx, 0, nz), node(nx, ny, nz),
              node(nx // 2, ny // 2, nz // 2)]
    return cantilever_config(
        tol_runtime=2e-4, max_iters=120, dt=1e-3, adaptive=False,
        mesh={"path": "synthetic://box/%d,%d,%d" % cells},
        output={"vtu_stride": vtu_stride, "probes": probes},
    )


def defer_output(output):
    """Time each VTU write of ``output`` (an output manager) on its writer
    thread and take ``Simulation.run``'s flush away, so frame 0's file is
    written while the next frames step.  Returns (the write seconds, the
    manager's own flush)."""
    writer = output._writer
    plain_submit, write_s = writer.submit, []

    def timed_submit(fn, *args):
        def timed(*a):
            t = time.perf_counter()
            fn(*a)
            write_s.append(time.perf_counter() - t)
        plain_submit(timed, *args)

    writer.submit = timed_submit
    manager_flush, output.flush = output.flush, lambda: None
    return write_s, manager_flush


def output_full_width_phase(device, split):
    """Phase 17b: the 255^3 cantilever stepped for 8 frames with the
    structured output manager (probes on the loaded face and at mid-span,
    VTU frame 0 written on the writer thread while frames 1-7 step),
    against phase 4's fused frames without output.  Its output directory
    is kept for phase 31 (which removes it)."""
    import shutil

    from civiwave_tpu_torch.post.structured_fields import (
        compute_structured_derived,
        probe_derived_host,
        probe_samples,
    )
    from civiwave_tpu_torch.runner import build_simulation

    cfg = output_255_config()
    probes = cfg.output.probes
    tmp = scratch_dir("output_255")
    try:
        sim = build_simulation(cfg, device=device, output_root=tmp)
        model = sim.model
        # one frame per run() call for per-frame times, without run()'s
        # flush of the writer, so frame 0's file is written while frames
        # 1-7 step; the flush is waited for after frame 8
        write_s, manager_flush = defer_output(sim.output)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_structured_counts()
        frame_s, tel = [], []
        for _ in range(8):
            t0 = time.perf_counter()
            tel += sim.run(1)
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        manager_flush()
        flush_s = time.perf_counter() - t0
        run_s = sum(frame_s) + flush_s
        peak = torch.cuda.max_memory_allocated()
        iters = [t.pcg_iterations for t in tel]
        if not all(t.pcg_converged for t in tel):
            fail(f"output 255^3: not every frame converged: {iters}")
        if any(abs(a - b) > 1 for a, b in zip(iters, split["iters"])):
            fail(f"output 255^3: iterations {iters} not within 1 of phase 4's "
                 f"fused frames {split['iters']}")
        if not bool(torch.isfinite(sim.stepper.state.displacement).all()):
            fail("output 255^3: non-finite displacement")
        frames = sorted(os.listdir(os.path.join(tmp, "vtu")))
        if frames != ["frame_00000.vtu"] or len(write_s) != 1:
            fail(f"output 255^3: VTU frames {frames}, writes {len(write_s)}")
        vtu_bytes = os.path.getsize(os.path.join(tmp, "vtu", frames[0]))
        header, table = probe_table(os.path.join(tmp, "probes", "probes.csv"))
        if table.shape != (8 * len(probes), 25):
            fail(f"output 255^3: probe table {table.shape}")

        # probe rows against the device node fields at those nodes
        state = sim.stepper.state
        kin, windows = probe_samples(model, state, probes)
        rows = probe_derived_host(model, probes, windows)
        fields = compute_structured_derived(model, state.displacement)
        node_stress = fields[4].permute(1, 2, 3, 0).reshape(-1, 6)
        node_strain = fields[3].permute(1, 2, 3, 0).reshape(-1, 6)
        smax = float(node_stress.abs().max())
        emax = float(node_strain.abs().max())
        idx = torch.as_tensor(probes, device=device)
        dev_stress = node_stress[idx].double().cpu().numpy()
        dev_strain = node_strain[idx].double().cpu().numpy()
        dev_vm = fields[5].reshape(-1)[idx].double().cpu().numpy()
        del fields, node_stress, node_strain
        worst = 0.0
        for p, (strain, stress, vm), ds, de, dv in zip(
                probes, rows, dev_stress, dev_strain, dev_vm):
            errs = (np.abs(stress - ds).max() / smax, np.abs(strain - de).max() / emax,
                    abs(vm - dv) / smax)
            if max(errs) > 1e-5:
                fail(f"output 255^3: probe {p} derived row differs from the device "
                     f"node fields by {max(errs):.3e} of max|.|")
            worst = max(worst, *errs)
        u_nodal = model.to_nodal(state.displacement)
        if not np.array_equal(kin[:, 0], u_nodal[idx].cpu().numpy()):
            fail("output 255^3: probe u rows differ from the state")

        # the derived fields' device time and the probe cost per frame
        derived_ms = time_ms(lambda: compute_structured_derived(model, state.displacement), 5)
        t0 = time.perf_counter()
        reps = 20
        for _ in range(reps):
            k_, w_ = probe_samples(model, state, probes)
            probe_derived_host(model, probes, w_)
        probe_ms = (time.perf_counter() - t0) / reps * 1e3
        steady = frame_s[1:]
        steps = len(steady) / sum(steady)
        print(f"output 255^3: frame seconds " + ", ".join(
            f"{t:.4f}" for t in frame_s) + f", then {flush_s:.4f} s waiting for "
              f"the writer; steps/s {steps:.4f} over frames 2-8 while frame 0's "
              f"VTU is written (phase 4 without output {split['steps_per_s']:.4f}), "
              f"{8 / run_s:.4f} over all 8 with the wait; iterations {iters} "
              f"(phase 4 {split['iters']})", flush=True)
        print(f"output 255^3: derived fields {derived_ms:.4f} ms device time (CUDA "
              f"events, 13 element + 13 node grids); probes {probe_ms:.4f} ms per "
              f"frame ({len(probes)} probes, one transfer); VTU frame 0 "
              f"{vtu_bytes:,} bytes written in {write_s[0]:.3f} s on the writer "
              f"thread (writer {'native' if native_writer() else 'numpy'}); probe "
              f"rows vs device node fields worst {worst:.3e} of max|.|; peak device "
              f"memory {peak / 2**30:.3f} GiB ({peak} bytes)", flush=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    del sim, model, state
    torch.cuda.empty_cache()
    return dict(steps_per_s=steps, derived_ms=derived_ms, probe_ms=probe_ms,
                vtu_bytes=vtu_bytes, vtu_write_s=write_s[0], iters=iters,
                root=tmp)


def dashpot_device_kernels(model, x):
    """Device kernels one application of the general dashpot term
    launches, counted by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from civiwave_tpu_torch.ops import apply_keff as gops

    damped = dataclasses.replace(model, damp_factor=1.0)
    out = torch.zeros_like(x)
    gops.add_dashpot_term(damped, out, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gops.add_dashpot_term(damped, out, x)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def tet_basin_phase(device):
    """Phase 17c: examples/seismic_basin.yaml meshed with tets (the general
    path with five absorbing faces): 10 frames with --output on the GPU and
    the CPU at 24x24x12, then 8 frames at 80x80x40 (807,003 DOF) on the
    GPU."""
    import shutil

    from civiwave_tpu_torch.config.loader import load_config_from_file
    from civiwave_tpu_torch.ops import apply_keff as gops
    from civiwave_tpu_torch.runner import build_simulation

    base = load_config_from_file(BASIN)
    cfg = dataclasses.replace(base, mesh_path="synthetic://box/24,24,12,tet")
    tmp = scratch_dir("tet_basin")
    runs = {}
    try:
        for side, dev in (("gpu", device), ("cpu", torch.device("cpu"))):
            root = os.path.join(tmp, side)
            sim = build_simulation(cfg, device=dev, output_root=root)
            if not sim.model.has_damping:
                fail("tet basin: no dashpots on the general path")
            reset_general_counts()
            tel = sim.run(10)
            runs[side] = (tel, sim.stepper.displacement(),
                              sim.stepper.acceleration(), general_counts(),
                              probe_table(os.path.join(root, "probes", "probes.csv")),
                              sorted(os.listdir(os.path.join(root, "vtu"))))
            del sim
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (tg, ug, ag, counts, pg, fg), (tc, uc, ac, _, pc, fc) = runs["gpu"], runs["cpu"]
    it_g = [t.pcg_iterations for t in tg]
    it_c = [t.pcg_iterations for t in tc]
    if any(abs(a - b) > 1 for a, b in zip(it_g, it_c)) or not all(
            t.pcg_converged for t in tg):
        fail(f"tet basin: iterations gpu {it_g} cpu {it_c}")
    if counts["element_forces_tet"] <= 0 or counts["assemble_csr"] <= 0:
        fail(f"tet basin: K7 tet / G1 not launched {counts}")
    if fg != fc:
        fail(f"tet basin: VTU frames gpu {fg} cpu {fc}")
    eu = check_rows("tet basin u", ug, uc, U_TOL)
    ea = check_rows("tet basin a", ag, ac, A_TOL)
    ep = check_probe_tables("tet basin", pg, pc)
    print(f"tet basin 24x24x12 (41,472 tets, general path, five absorbing faces) "
          f"10 frames with output: iterations gpu {it_g} cpu {it_c}; max err / "
          f"max|cpu| u {eu:.3e} a {ea:.3e} probes {ep:.3e}; VTU frames {fg}; gpu "
          f"launches {counts}", flush=True)

    n = TET_BASIN
    cfg = dataclasses.replace(base, mesh_path="synthetic://box/%d,%d,%d,tet" % n)
    t0 = time.perf_counter()
    sim = build_simulation(cfg, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = sim.model
    if model.tet_count != 6 * int(np.prod(n)) or model.dof_count != 3 * int(
            np.prod([c + 1 for c in n])):
        fail(f"tet basin full width: {model.tet_count:,} tets, {model.dof_count:,} DOF")
    torch.cuda.reset_peak_memory_stats()
    reset_general_counts()
    dash0 = gops.add_dashpot_term.calls
    frame_s, tel = [], []
    for _ in range(8):
        t0 = time.perf_counter()
        tel += sim.run(1)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    counts = general_counts()
    dash = gops.add_dashpot_term.calls - dash0
    peak = torch.cuda.max_memory_allocated()
    iters = [t.pcg_iterations for t in tel]
    if not all(t.pcg_converged for t in tel) or sum(iters) <= 0:
        fail(f"tet basin full width: frames {iters}")
    if not bool(torch.isfinite(sim.stepper.state.displacement).all()):
        fail("tet basin full width: non-finite displacement")
    # matvecs with the term: one initial residual per frame plus one per
    # iteration (the Rayleigh-beta matvec runs outside the step's model)
    matvecs = len(tel) + sum(iters)
    if dash != matvecs or counts["element_forces_tet"] != matvecs + len(tel):
        fail(f"tet basin full width: {dash} dashpot terms and {counts} launches "
             f"for {matvecs} step matvecs")
    kernels_per_term = dashpot_device_kernels(
        model, torch.randn(model.vector_shape, device=device))
    steady = frame_s[1:]
    print(f"tet basin full width ({model.tet_count:,} tets, {model.node_count:,} "
          f"nodes, {model.dof_count:,} DOF, D {model.csr_degree}): build "
          f"{build_s:.3f} s; iterations {iters}; frame seconds " + ", ".join(
              f"{t:.4f}" for t in frame_s) + f"; steps/s {len(steady) / sum(steady):.4f} "
          f"(frames 2-8), {sum(steady) / sum(iters[1:]) * 1e3:.4f} ms per iteration; "
          f"peak device memory {peak / 2**30:.3f} GiB ({peak} bytes)", flush=True)
    print(f"tet basin full width: launches {counts} (K7 tet and G1 per frame "
          f"{counts['element_forces_tet'] / len(tel):.2f}); dashpot term {dash} "
          f"applications = one per step matvec, {kernels_per_term} device kernels "
          f"each", flush=True)
    profile_window("tet basin full width frame 9", lambda: sim.run(1))
    del sim, model
    torch.cuda.empty_cache()
    return counts


# --- the opt-in solvers: multigrid and pipelined PCG (phases 18-19) ----------
MG_AB = (96, 56, 56)  # ADR-15's crossover size: 945,459 DOF
REPLACE_EVERY = 10
PIPELINED_STATIC_SWEEP = (63, 127, 191)  # cubes below 255^3, phase 19


def solver_node(**kw):
    """A complete ``solver`` node for cantilever_config (it replaces the
    default one): block-Jacobi, tol 2e-4, pause 1e-8, STATIC_MAX_ITERS."""
    node = {"type": "pcg", "preconditioner": "block_jacobi",
            "tol_runtime": 2e-4, "tol_pause": 1e-8,
            "max_iters": STATIC_MAX_ITERS}
    node.update(kw)
    return node


def stepping_config(cells, **solver):
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    return cantilever_config(
        dt=1e-3, adaptive=False, mesh={"path": "synthetic://box/%d,%d,%d" % cells},
        solver=solver_node(**solver),
    )


def run_frames(sim, frames):
    """``frames`` frames one at a time: (telemetries, seconds per frame)."""
    tel, secs = [], []
    for _ in range(frames):
        t0 = time.perf_counter()
        tel += sim.run(1)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return tel, secs


def check_state(label, state, ref=None):
    """Finite u, v, a; with ``ref`` (cpu u and a) u and a at the BASELINE
    tolerances.  Returns the errors over max|ref|."""
    errs = {}
    for name in ("displacement", "velocity", "acceleration"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            fail(f"{label}: non-finite {name}")
    if ref is not None:
        for name, key, tol in (("displacement", "u", U_TOL),
                               ("acceleration", "a", A_TOL)):
            _, errs[key] = check_close(f"{label} {name}",
                                       getattr(state, name).cpu(), ref[key], tol)
    return errs


def multigrid_phase(device, split, static):
    """Phase 18: the geometric multigrid V(1,1) on the 255^3 cantilever:
    K1 on every level against the plain operator, the CUDA V-cycle against
    the V-cycle of the plain versions, 8 'auto' (= classic) frames against
    phase 4's, the static solve against phase 16's refined u, and the
    945k-DOF A/B against block-Jacobi."""
    from civiwave_tpu_torch.ops import structured as tops
    from civiwave_tpu_torch.ops.cuda import structured_stencil as k12
    from civiwave_tpu_torch.runner import build_simulation, run_static
    from civiwave_tpu_torch.solver.stepper import effective_scalars

    t0 = time.perf_counter()
    sim = build_simulation(stepping_config(FULL, preconditioner="multigrid"),
                           device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = sim.model
    if not model.multigrid:
        fail("multigrid: no hierarchy attached at 255^3")
    levels = (model,) + model.mg_levels
    print(f"multigrid 255^3: {len(model.mg_levels)} coarse levels "
          f"{[lvl.grid_shape for lvl in model.mg_levels]}, omegas "
          f"{[round(w, 6) for w in model.mg_omegas]}, build {build_s:.3f} s "
          f"(model, hierarchy, power iterations)", flush=True)

    # K1 on every level at the step's (ss, mf) against the plain operator,
    # which reads the stored mass; the raw kernel's error shows the trap
    ray = sim.stepper.rayleigh
    ss, mf = effective_scalars(1e-3, ray.alpha, ray.beta)
    worst = (0.0, 0.0)
    for i, lvl in enumerate(levels):
        x = random_vector(lvl, device)
        out = tops.apply_keff_structured(lvl, x, ss, mf)
        ref = tops.apply_keff_structured_plain(lvl, x, ss, mf)
        err = check_close(f"multigrid level {i} K1", out, ref, OP_TOL)
        worst = max(worst, err, key=lambda e: e[1])
        raw = float((k12.apply_keff_fused(lvl, x, ss, mf) - ref).abs().max()) / float(
            ref.abs().max())
        corr = lvl.mass_correction
        print(f"multigrid level {i} {lvl.grid_shape}: K1 max abs err / max|plain| "
              f"{err[1]:.3e} (tol {OP_TOL:g}); without the mass correction "
              f"{raw:.3e}; corrected nodes "
              f"{0 if corr is None else corr.index.numel():,}", flush=True)
        del x, out, ref
    torch.cuda.empty_cache()

    # the V-cycle on the card against the V-cycle of the plain versions
    pc = model.build_preconditioner(ss, mf)
    r = random_vector(model, device).masked_fill(model.bc_mask, 0.0)
    before = k12.apply_keff_fused.launches
    z = model.apply_preconditioner(pc, r)
    k1_per_vcycle = k12.apply_keff_fused.launches - before
    kernel_op = tops.apply_keff_structured
    tops.apply_keff_structured = tops.apply_keff_structured_plain
    try:
        z_plain = model.apply_preconditioner(pc, r)
        vc_plain_ms = time_ms(lambda: model.apply_preconditioner(pc, r), 2)
    finally:
        tops.apply_keff_structured = kernel_op
    vc_err = check_close("multigrid V-cycle", z, z_plain, OP_TOL)
    vc_ms = time_ms(lambda: model.apply_preconditioner(pc, r), 10)
    print(f"multigrid V-cycle 255^3: max abs err / max|plain V-cycle| "
          f"{vc_err[1]:.3e} (tol {OP_TOL:g}); {k1_per_vcycle} K1 launches; "
          f"{vc_ms:.4f} ms (CUDA events, 10 reps), plain versions "
          f"{vc_plain_ms:.4f} ms", flush=True)
    del pc, r, z, z_plain
    torch.cuda.empty_cache()

    # 8 'auto' frames: classic PCG preconditioned by the V-cycle
    torch.cuda.reset_peak_memory_stats()
    reset_structured_counts()
    tel, secs = run_frames(sim, 8)
    counts = structured_counts()
    peak = torch.cuda.max_memory_allocated()
    iters = [t.pcg_iterations for t in tel]
    if not all(t.pcg_converged for t in tel):
        fail(f"multigrid 255^3: not every frame converged: {iters}")
    if counts["keff"] <= 0 or counts["pc"] or counts["k6"] or counts["bj"]:
        fail(f"multigrid 255^3: wrong kernels {counts}")
    # per frame: the Rayleigh and residual matvecs, one V-cycle per
    # iteration and setup, one operator matvec per iteration
    want_k1 = sum(2 + (n + 1) * k1_per_vcycle + n for n in iters)
    if counts["keff"] != want_k1:
        fail(f"multigrid 255^3: {counts['keff']} K1 launches, expected {want_k1}")
    check_state("multigrid 255^3", sim.stepper.state)
    loose = dict(u=sim.stepper.state.displacement.cpu(),
                 a=sim.stepper.state.acceleration.cpu())
    steady = secs[1:]
    result = dict(iters=iters, counts=counts, k1_per_vcycle=k1_per_vcycle,
                  steps_per_s=len(steady) / sum(steady),
                  ms_per_iter=sum(steady) / sum(iters[1:]) * 1e3,
                  vcycle_ms=vc_ms, level_err=worst)
    print(f"multigrid 255^3: pcg iterations per frame {iters} (phase 4 fused "
          f"block-Jacobi {split['iters']})", flush=True)
    print("multigrid 255^3: frame seconds " + ", ".join(f"{t:.4f}" for t in secs),
          flush=True)
    print(f"multigrid 255^3: steps/s {result['steps_per_s']:.4f} (frames 2-8; "
          f"phase 4 fused {split['steps_per_s']:.4f}), {result['ms_per_iter']:.4f} "
          f"ms per iteration (phase 4 fused {split['ms_per_iter']:.4f}); launches "
          f"{counts}; peak device memory {peak / 2**30:.3f} GiB ({peak} bytes)",
          flush=True)
    profile_window("multigrid 255^3 frame 9", lambda: sim.run(1))

    # the static solve ('auto' = classic under multigrid) against phase 16
    reset_structured_counts()
    u, payload = run_static(sim)
    torch.cuda.synchronize()
    if not payload["converged"] or not bool(torch.isfinite(u).all()):
        fail(f"multigrid static 255^3: converged {payload['converged']} in "
             f"{payload['iterations']} iterations")
    exact = static["exact"]
    err = float((u.double() - exact).abs().max()) / float(exact.abs().max())
    if not err <= U_TOL:
        fail(f"multigrid static 255^3: u off the refined f64 solution by {err:.3e}")
    result["static"] = dict(iterations=payload["iterations"],
                            seconds=payload["elapsed_seconds"], err=err,
                            counts=structured_counts())
    print(f"multigrid static 255^3: {payload['iterations']} iterations in "
          f"{payload['elapsed_seconds']:.4f} s (block-Jacobi classic "
          f"{static['classic']['iterations']} in {static['classic']['seconds']:.4f} "
          f"s), u against the refined f64 solution {err:.3e} of max|u| (classic "
          f"block-Jacobi's is PERF.md §6's 1.5e-5); launches "
          f"{result['static']['counts']}", flush=True)
    del sim, model, u
    torch.cuda.empty_cache()

    # correctness of the trajectory: converged (1e-8), multigrid and
    # block-Jacobi classic step the same 8 frames at the BASELINE
    # tolerances.  At 2e-4 two preconditioners stop at different iterates
    # of the same solve, each some 4e-4 of max|u| off the converged
    # trajectory (PERF.md §6), so the 2e-4 runs are measured against it
    tight = {}
    for label, pre, variant in (("multigrid", "multigrid", "auto"),
                                ("block-Jacobi classic", "block_jacobi", "classic")):
        sim = build_simulation(stepping_config(
            FULL, preconditioner=pre, variant=variant, tol_runtime=1e-8),
            device=device)
        tel, secs = run_frames(sim, 8)
        it = [t.pcg_iterations for t in tel]
        if not all(t.pcg_converged for t in tel):
            fail(f"multigrid tight {label}: not every frame converged: {it}")
        check_state(f"multigrid tight {label}", sim.stepper.state)
        tight[label] = dict(iters=it, seconds=sum(secs),
                            u=sim.stepper.state.displacement.cpu(),
                            a=sim.stepper.state.acceleration.cpu())
        del sim
        torch.cuda.empty_cache()
    ref = tight["block-Jacobi classic"]
    terr = {key: check_close(f"multigrid tight {key}", tight["multigrid"][key],
                             ref[key], tol)[1]
            for key, tol in (("u", U_TOL), ("a", A_TOL))}
    dist = {k: {f: float((v[f] - ref[f]).abs().max() / ref[f].abs().max())
                for f in ("u", "a")}
            for k, v in (("multigrid 2e-4", loose), ("fused 2e-4", split))}
    result["tight"] = dict(iters={k: v["iters"] for k, v in tight.items()},
                           err=terr, dist=dist)
    print(f"multigrid 255^3 at tol 1e-8, 8 frames: iterations "
          f"{tight['multigrid']['iters']} ({tight['multigrid']['seconds']:.3f} s); "
          f"block-Jacobi classic {ref['iters']} ({ref['seconds']:.3f} s); max abs "
          f"err / max|block-Jacobi| u {terr['u']:.3e} (tol {U_TOL:g}), a "
          f"{terr['a']:.3e} (tol {A_TOL:g}).  At tol 2e-4, off this converged "
          f"trajectory: multigrid u {dist['multigrid 2e-4']['u']:.3e} a "
          f"{dist['multigrid 2e-4']['a']:.3e}; phase 4 fused u "
          f"{dist['fused 2e-4']['u']:.3e} a {dist['fused 2e-4']['a']:.3e}",
          flush=True)

    # A/B at ADR-15's crossover size: multigrid (classic) against
    # block-Jacobi ('auto' = fused)
    ab = {}
    for label, pre in (("multigrid", "multigrid"), ("block-Jacobi", "block_jacobi")):
        sim = build_simulation(stepping_config(MG_AB, preconditioner=pre),
                               device=device)
        tel, secs = run_frames(sim, 8)
        it = [t.pcg_iterations for t in tel]
        if not all(t.pcg_converged for t in tel):
            fail(f"multigrid A/B {label}: not every frame converged: {it}")
        check_state(f"multigrid A/B {label}", sim.stepper.state)
        ab[label] = dict(iters=it, steps_per_s=7 / sum(secs[1:]),
                         u=sim.stepper.state.displacement.cpu())
        del sim
    ab_err = float((ab["multigrid"]["u"] - ab["block-Jacobi"]["u"]).abs().max()
                   / ab["block-Jacobi"]["u"].abs().max())
    dof = 3 * int(np.prod([n + 1 for n in MG_AB]))
    print(f"multigrid A/B {MG_AB} ({dof:,} DOF), 8 frames: multigrid iterations "
          f"{ab['multigrid']['iters']} (mean {np.mean(ab['multigrid']['iters']):.2f}), "
          f"{ab['multigrid']['steps_per_s']:.4f} steps/s; block-Jacobi fused "
          f"{ab['block-Jacobi']['iters']} (mean "
          f"{np.mean(ab['block-Jacobi']['iters']):.2f}), "
          f"{ab['block-Jacobi']['steps_per_s']:.4f} steps/s; u {ab_err:.3e} of "
          f"max|u| apart (both at tol 2e-4)",
          flush=True)
    result["ab"] = {k: dict(iters=v["iters"], steps_per_s=v["steps_per_s"])
                    for k, v in ab.items()}
    torch.cuda.empty_cache()
    return result


def pipelined_pc_calls(iters):
    """apply_pc_keff calls of pipelined solves that took ``iters``: the
    setup, every loop body (the stopping one included; none when the loop
    does not run) and every replacement."""
    return sum(1 + (n + 1 + n // REPLACE_EVERY if n else 0) for n in iters)


def pipelined_phase(device, split, static, tet_classic):
    """Phase 19: pipelined PCG (replace_every 10) on the 255^3 cantilever's
    8 frames and its static solve, on the 66^3 tet cantilever (the general
    path) and on a one-rank NCCL shard of the 255^3 grid."""
    from civiwave_tpu_torch.parallel.sharding import (
        close_shard_group,
        make_shard_group,
        shard_simulation,
    )
    from civiwave_tpu_torch.runner import build_simulation, run_static

    pipe = dict(variant="pipelined", replace_every=REPLACE_EVERY)
    sim = build_simulation(stepping_config(FULL, **pipe), device=device)
    torch.cuda.reset_peak_memory_stats()
    reset_structured_counts()
    tel, secs, third = [], [], None
    for _ in range(8):
        tel_one, sec = run_frames(sim, 1)
        tel += tel_one
        secs += sec
        if len(tel) == 3:
            third = dict(u=sim.stepper.state.displacement.cpu(),
                         a=sim.stepper.state.acceleration.cpu())
    counts = structured_counts()
    peak = torch.cuda.max_memory_allocated()
    iters = [t.pcg_iterations for t in tel]
    if not all(t.pcg_converged for t in tel):
        fail(f"pipelined 255^3: not every frame converged: {iters}")
    bound = [max(3, int(0.2 * n)) for n in split["iters"]]
    if any(abs(a - b) > c for a, b, c in zip(iters, split["iters"], bound)):
        fail(f"pipelined 255^3: iterations {iters} not within max(3, 20 %) of "
             f"phase 4's fused {split['iters']}")
    want_pc = pipelined_pc_calls(iters)
    if counts["pc"] != want_pc or counts["k6"] or counts["bj"]:
        fail(f"pipelined 255^3: launches {counts}, expected {want_pc} K2")
    errs = check_state("pipelined 255^3", sim.stepper.state, split)
    steady = secs[1:]
    result = dict(iters=iters, counts=counts, steps_per_s=len(steady) / sum(steady),
                  ms_per_iter=sum(steady) / sum(iters[1:]) * 1e3)
    print(f"pipelined 255^3 (replace_every {REPLACE_EVERY}): pcg iterations "
          f"{iters} (phase 4 fused {split['iters']}); max abs err / max|phase 4| "
          f"u {errs['u']:.3e} (tol {U_TOL:g}), a {errs['a']:.3e}", flush=True)
    print(f"pipelined 255^3: steps/s {result['steps_per_s']:.4f} (frames 2-8; "
          f"fused {split['steps_per_s']:.4f}), {result['ms_per_iter']:.4f} ms per "
          f"iteration (fused {split['ms_per_iter']:.4f}); K2 launches {counts['pc']} "
          f"= {counts['pc'] / sum(iters):.4f} per iteration with the setups, "
          f"trailing bodies and {sum(n // REPLACE_EVERY for n in iters)} "
          f"replacements; launches {counts}; peak {peak / 2**30:.3f} GiB", flush=True)
    profile_window("pipelined 255^3 frame 9", lambda: sim.run(1))

    # the static solve: a stall is a finding; breakdown, non-finite u or a
    # kernel error fail
    reset_structured_counts()
    u, payload = run_static(sim, variant="pipelined")
    torch.cuda.synchronize()
    cap = sim.config.solver.max_iterations
    if not payload["converged"] and payload["iterations"] < cap:
        fail(f"pipelined static 255^3: breakdown after {payload['iterations']} "
             f"iterations")
    if not bool(torch.isfinite(u).all()):
        fail("pipelined static 255^3: non-finite u")
    exact = static["exact"]
    err = float((u.double() - exact).abs().max()) / float(exact.abs().max())
    result["static"] = dict(iterations=payload["iterations"],
                            converged=payload["converged"],
                            seconds=payload["elapsed_seconds"], err=err,
                            counts=structured_counts())
    print(f"pipelined static 255^3 (replace_every {REPLACE_EVERY}): "
          f"{payload['iterations']} iterations in {payload['elapsed_seconds']:.4f} s, "
          f"converged {payload['converged']} (recurred residual "
          f"{payload['residual_norm']:.3e} of rhs {payload['rhs_norm']:.3e}); u "
          f"against the refined f64 solution {err:.3e} of max|u| (fused "
          f"block-Jacobi: PERF.md §6's 1.08e-3, classic 1.5e-5); iterations: "
          f"classic {static['classic']['iterations']}, fused "
          f"{static['fused']['iterations']}; launches "
          f"{result['static']['counts']}", flush=True)
    del sim, u
    torch.cuda.empty_cache()

    # how the static solve's iterations grow with the grid: classic and
    # pipelined (replace_every 10) on smaller cubes of the same cantilever
    from civiwave_tpu_torch.mesh.structured import build_structured_model
    from civiwave_tpu_torch.physics import materials
    from civiwave_tpu_torch.solver.static import solve_static
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    mat = cantilever_config().materials[0]
    sweep = {}
    for n in PIPELINED_STATIC_SWEEP:
        model, force = build_structured_model(
            n, n, n, materials.make_properties(mat), mat.density,
            traction=(0.0, 0.0, -1.0e6), device=device)
        for variant in ("classic", "pipelined"):
            t0 = time.perf_counter()
            u, tel = solve_static(model, force, tolerance=1e-8,
                                  max_iterations=STATIC_MAX_ITERS,
                                  variant=variant, replace_every=REPLACE_EVERY)
            torch.cuda.synchronize()
            if tel.breakdown or not bool(torch.isfinite(u).all()):
                fail(f"static {n}^3 {variant}: breakdown or non-finite u")
            sweep[(n, variant)] = (tel.iterations, tel.converged,
                                   time.perf_counter() - t0)
        del model, force, u
    result["static_sweep"] = sweep
    print("static solves by size (classic | pipelined, replace_every "
          f"{REPLACE_EVERY}; iterations, converged, s): " + "; ".join(
              f"{n}^3 {sweep[(n, 'classic')][0]}, {sweep[(n, 'classic')][1]}, "
              f"{sweep[(n, 'classic')][2]:.3f} | {sweep[(n, 'pipelined')][0]}, "
              f"{sweep[(n, 'pipelined')][1]}, {sweep[(n, 'pipelined')][2]:.3f}"
              for n in PIPELINED_STATIC_SWEEP), flush=True)
    torch.cuda.empty_cache()

    # the general path: the 66^3 tet cantilever, pipelined against phase
    # 8's classic frames
    n = GENERAL_N
    cfg = cantilever_config(
        mesh={"path": f"synthetic://box/{n},{n},{n},tet"}, dt=1e-3,
        adaptive=False, solver=solver_node(max_iters=300, **pipe),
    )
    sim = build_simulation(cfg, device=device)
    reset_general_counts()
    tel, secs = run_frames(sim, 8)
    gcounts = general_counts()
    git = [t.pcg_iterations for t in tel]
    if not all(t.pcg_converged for t in tel):
        fail(f"pipelined tet 66^3: not every frame converged: {git}")
    ref_it = tet_classic["iters"]
    if any(abs(a - b) > max(3, int(0.2 * b)) for a, b in zip(git, ref_it)):
        fail(f"pipelined tet 66^3: iterations {git} not within max(3, 20 %) of "
             f"classic {ref_it}")
    # per frame: the Rayleigh and residual matvecs and one per pc+matvec
    want = 2 * len(git) + pipelined_pc_calls(git)
    if gcounts["element_forces_tet"] != want or gcounts["assemble_csr"] != want:
        fail(f"pipelined tet 66^3: launches {gcounts}, expected {want} each")
    u = sim.stepper.displacement()
    ref_u = tet_classic["u"]
    gerr = float(np.abs(u - ref_u).max() / np.abs(ref_u).max())
    if not gerr <= U_TOL:
        fail(f"pipelined tet 66^3: u {gerr:.3e} off classic's")
    result["general"] = dict(iters=git, counts=gcounts,
                             steps_per_s=7 / sum(secs[1:]))
    print(f"pipelined tet 66^3: iterations {git} (classic {ref_it}); u "
          f"{gerr:.3e} of max|u| off classic's (tol {U_TOL:g}); "
          f"{result['general']['steps_per_s']:.4f} steps/s (frames 2-8); "
          f"launches {gcounts}", flush=True)
    del sim
    torch.cuda.empty_cache()

    # a one-rank NCCL shard of the 255^3 grid: K3 and K5 composed, one f64
    # (3,) all-reduce per loop body, 2 ghost exchanges per matvec
    sim = shard_simulation(build_simulation(stepping_config(FULL, **pipe),
                                            device=device),
                           make_shard_group(1, device))
    reset_sharded_counts()
    tel, secs = run_frames(sim, 3)
    scounts = sharded_counts()
    sit = [t.pcg_iterations for t in tel]
    close_shard_group()
    if not all(t.pcg_converged for t in tel) or any(
            abs(a - b) > 1 for a, b in zip(sit, iters)):
        fail(f"pipelined shard 255^3: iterations {sit} vs unsharded {iters[:3]}")
    bodies = sum(k + 1 for k in sit if k)
    pc_calls = pipelined_pc_calls(sit)
    matvecs = 2 * len(sit) + pc_calls
    want = {"k5": 3 * matvecs, "bj": pc_calls, "keff": 0, "pc": 0, "k6": 0,
            "ppermute": 2 * matvecs, "psum": bodies + len(sit),
            "psum_f64_3": bodies, "psum_f64_4": 0}
    if scounts != want:
        fail(f"pipelined shard 255^3: counts {scounts}, expected {want}")
    serrs = check_state("pipelined shard 255^3", sim.stepper.state, third)
    result["shard"] = dict(iters=sit, counts=scounts)
    print(f"pipelined shard 255^3 (one rank, NCCL), 3 frames: iterations {sit} "
          f"(unsharded {iters[:3]}); u {serrs['u']:.3e}, a {serrs['a']:.3e} of the "
          f"unsharded pipelined frame 3; {bodies} f64 (3,) all-reduces for "
          f"{sum(sit)} iterations, {scounts['ppermute']} ghost exchanges for "
          f"{matvecs} matvecs; counts {scounts}", flush=True)
    del sim
    torch.cuda.empty_cache()
    return result


# --- fp64 vectors on the card, checkpoints and --profile (phases 20-23) ------

F64_TOL = 1e-12  # f64 instances against their plain versions, of max|ref|
F64_TFLOPS = 34.0  # H100 SXM published f64 rate outside the tensor cores
# least bytes per node of K1's and K3's f64 instances: x (24 B) and the mask
# (3 B) read once, out (24 B) written once; a K5 ghost node's 3 f64 values
# and 3 mask bytes
F64_BYTES_PER_NODE, K5_GHOST_BYTES_F64 = 51, 27
BOX_F64_TOL = (1e-8, 1e-6)  # u, a of max: cantilever_box fp64 GPU vs CPU
MG_F64_TOL = 1e-8  # multigrid vs block-Jacobi fp64 at tol 1e-10, of max|u|
FP64 = {"vectors": "fp64", "reductions": "fp64"}
# the f64 instances' mangled names (template argument double)
F64_KERNELS = ("keff_sweep_kernelId", "block_jacobi_apply_kernelId",
               "element_forces_kernelId", "assemble_csr_kernelId")


def f64_counts():
    """Launches of the f64 instances, by short name."""
    from civiwave_tpu_torch.ops.cuda import assemble_csr as g1
    from civiwave_tpu_torch.ops.cuda import block_jacobi_apply as k3
    from civiwave_tpu_torch.ops.cuda import element_forces as k7
    from civiwave_tpu_torch.ops.cuda import keff_halo as k5
    from civiwave_tpu_torch.ops.cuda import structured_stencil as k12

    return {"keff_f64": k12.apply_keff_fused.launches_f64,
            "k5_f64": k5.keff_structured_halo.launches_f64,
            "bj_f64": k3.apply_block_jacobi.launches_f64,
            "tet_f64": k7.tet_element_forces.launches_f64,
            "hex_f64": k7.hex_element_forces.launches_f64,
            "g1_f64": g1.assemble_keff.launches_f64}


def reset_f64_counts():
    """Every launch counter to 0: the f64 instances' and the f32 ones'."""
    from civiwave_tpu_torch.ops.cuda import assemble_csr as g1
    from civiwave_tpu_torch.ops.cuda import block_jacobi_apply as k3
    from civiwave_tpu_torch.ops.cuda import element_forces as k7
    from civiwave_tpu_torch.ops.cuda import keff_halo as k5
    from civiwave_tpu_torch.ops.cuda import structured_stencil as k12

    for wrapper in (k12.apply_keff_fused, k5.keff_structured_halo,
                    k3.apply_block_jacobi, k7.tet_element_forces,
                    k7.hex_element_forces, g1.assemble_keff):
        wrapper.launches_f64 = 0
    reset_all_counts()
    reset_general_counts()


def fp64_path_counts():
    """Every counter after an fp64 path: the f64 instances', then the f32
    kernels' (all of which must stay 0 there)."""
    return {**f64_counts(), **all_counts(), **general_counts()}


def check_fp64_counts(label, counts, want):
    """The f64 instances of ``want`` launched, every f32 kernel never."""
    f32 = {k: v for k, v in counts.items() if not k.endswith("_f64") and v}
    missing = [k for k in want if counts[k] <= 0]
    if f32 or missing:
        fail(f"{label}: f32 kernels launched {f32}, f64 instances never "
             f"launched {missing}; counts {counts}")


def f64_kernel_phase(device, times32, hex32, tet32):
    """Phase 20: the f64 instances against their plain versions in f64 at
    F64_TOL — K1 at 255^3, on the soil column's grid and a ragged grid, K5
    on the 64-plane slabs of 255^3 with their ghosts (gathered against K1
    bit for bit), K3 at 255^3, K7 and G1 on the 66^3 tet and hex boxes —
    timed beside the f32 instances' times of phases 3 and 6-8."""
    from civiwave_tpu_torch.mesh.structured import build_structured_model
    from civiwave_tpu_torch.ops.cuda import _build
    from civiwave_tpu_torch.ops.cuda import assemble_csr as g1
    from civiwave_tpu_torch.ops.cuda import block_jacobi_apply as k3
    from civiwave_tpu_torch.ops.cuda import element_forces as k7
    from civiwave_tpu_torch.ops.cuda import keff_halo as k5
    from civiwave_tpu_torch.ops.cuda import structured_stencil as k12
    from civiwave_tpu_torch.physics import materials
    from civiwave_tpu_torch.solver.stepper import effective_scalars
    from civiwave_tpu_torch.utils.synthetic import box_mesh, cantilever_config

    for line in ptxas_report(_build.load_library().log, F64_KERNELS):
        print(f"  ptxas f64: {line}", flush=True)
    cfg = cantilever_config()
    mat = materials.make_properties(cfg.materials[0])
    rho = cfg.materials[0].density
    ray = materials.compute_rayleigh(cfg.damping)
    ss, mf = effective_scalars(1.0e-3, ray.alpha, ray.beta, vector_precision="fp64")
    gen = torch.Generator(device=device).manual_seed(SEED + 20)

    def rand64(model):
        return torch.randn(model.vector_shape, generator=gen, device=device,
                           dtype=torch.float64)

    errs, out = {}, {}
    column, _ = column_model(device)
    for label, model in (
        ("33x19x45 fixes x0,y1,z0 partial", build_structured_model(
            33, 19, 45, mat, rho, device=device, fixes=[
                ("x0", (True, True, True), (None, None, None)),
                ("y1", (False, True, False), (None, None, None)),
                ("z0", (True, False, True), (1e-3, None, None))])[0]),
        ("soil column 1024x48x48", column),
        ("255x255x255", build_structured_model(*FULL, mat, rho, device=device)[0]),
    ):
        x = rand64(model)
        e = check_close(f"K1 f64 {label}", k12.apply_keff_fused(model, x, ss, mf),
                        k12.apply_keff_fused_plain(model, x, ss, mf), F64_TOL)
        errs["keff"] = max(errs.get("keff", e), e, key=lambda v: v[1])
        print(f"K1 f64 vs plain [{label}]: max abs err {e[0]:.3e}, "
              f"{e[1]:.2e} of max|ref| (tol {F64_TOL:g})", flush=True)
    del column
    nodes = int(np.prod(model.grid_shape))
    pc = model.build_preconditioner(ss, mf)
    errs["bj"] = check_close("K3 f64 255^3", k3.apply_block_jacobi(model, pc.table, x),
                             k3.apply_block_jacobi_plain(model, pc.table, x), F64_TOL)
    least = F64_BYTES_PER_NODE * nodes
    out["keff"] = report_time(
        "K1 f64", "255^3",
        time_ms(lambda: k12.apply_keff_fused(model, x, ss, mf), 20),
        time_ms(lambda: k12.apply_keff_fused_plain(model, x, ss, mf), 3),
        least, KERNEL_FLOPS_PER_NODE["keff"] * nodes, tflops=F64_TFLOPS)
    out["bj"] = report_time(
        "K3 f64", "255^3",
        time_ms(lambda: k3.apply_block_jacobi(model, pc.table, x), 20),
        time_ms(lambda: k3.apply_block_jacobi_plain(model, pc.table, x), 3),
        least, KERNEL_FLOPS_PER_NODE["bj"] * nodes, tflops=F64_TFLOPS)
    print(f"f64 vs f32 at 255^3: K1 {out['keff']['ms']:.4f} vs {times32['keff'][0]:.4f} "
          f"ms, K3 {out['bj']['ms']:.4f} vs {times32['bj'][0]:.4f} ms; K3 f64 vs plain "
          f"{errs['bj'][1]:.2e} of max|ref|", flush=True)
    del model, x, pc
    torch.cuda.empty_cache()

    # K5: 255^3 over 4 slabs of 64 planes, ghosts cut from the global x
    model, _ = build_structured_model(*FULL, mat, rho, device=device,
                                      pad_x_multiple=4)
    x = rand64(model)
    gathered = torch.empty_like(x)
    tiles = halo_tiles(model, x, (4, 1), False)
    for local, xt, ghosts, (x0, y0, xl, yl) in tiles:
        o = k5.keff_structured_halo(local, xt, ghosts, ss, mf)
        e = check_close(f"K5 f64 slab {x0}", o, k5.keff_structured_halo_plain(
            local, xt, ghosts, ss, mf), F64_TOL)
        errs["k5"] = max(errs.get("k5", e), e, key=lambda v: v[1])
        gathered[:, x0:x0 + xl, y0:y0 + yl] = o
    if not torch.equal(gathered, k12.apply_keff_fused(model, x, ss, mf)):
        fail("K5 f64: the gathered slabs differ from K1 f64")
    local, xt, ghosts, _ = tiles[1]
    least = (F64_BYTES_PER_NODE * int(np.prod(local.grid_shape))
             + K5_GHOST_BYTES_F64 * 2 * local.grid_shape[1] * local.grid_shape[2])
    out["k5"] = report_time(
        "K5 f64", f"slab {tuple(local.grid_shape)}",
        time_ms(lambda: k5.keff_structured_halo(local, xt, ghosts, ss, mf), 20),
        time_ms(lambda: k5.keff_structured_halo_plain(local, xt, ghosts, ss, mf), 3),
        least, KERNEL_FLOPS_PER_NODE["keff"] * int(np.prod(local.grid_shape)),
        tflops=F64_TFLOPS)
    print(f"K5 f64: 4 slabs vs plain max {errs['k5'][1]:.2e} of max|ref|, gathered "
          f"= K1 f64 bit for bit", flush=True)
    del model, x, gathered, tiles, local, xt, ghosts
    torch.cuda.empty_cache()

    # K7 and G1 on the 66^3 boxes
    n = GENERAL_N
    for block, f32 in (("tet", tet32), ("hex", hex32)):
        model, _, build_s = packed_model(
            box_mesh(n, n, n, hex_elements=block == "hex"), cfg, device)
        x = rand64(model)
        wrapper = k7.tet_element_forces if block == "tet" else k7.hex_element_forces
        errs[block] = check_close(f"K7 {block} f64 66^3", wrapper(model, x, ss),
                                  k7.element_forces_plain(model, x, ss, block),
                                  F64_TOL)
        rows = k7.element_force_rows(model, x, ss)
        g = g1.assemble_keff(model, rows, x, mf)
        ref = g1.assemble_keff_plain(model, rows, x, mf)
        e = check_close(f"G1 f64 {block} 66^3", g, ref, F64_TOL)
        if not torch.equal(g, ref):
            fail(f"G1 f64 {block} 66^3: not bit-equal to the plain version")
        errs[f"g1_{block}"] = e
        del rows, g, ref
        out[block] = report_time(f"K7 {block} f64", f"{block} 66^3",
                                 *time_k7(model, x, ss, block), tflops=F64_TFLOPS)
        out[f"g1_{block}"] = report_time(f"G1 f64", f"{block} 66^3",
                                         *time_g1(model, x, mf), tflops=F64_TFLOPS)
        print(f"f64 vs f32 [{block} 66^3, pack {build_s:.3f} s]: K7 "
              f"{out[block]['ms']:.4f} vs {f32['k7']:.4f} ms, G1 "
              f"{out[f'g1_{block}']['ms']:.4f} vs {f32['g1']:.4f} ms; K7 vs plain "
              f"{errs[block][1]:.2e}, G1 bit-equal", flush=True)
        del model, x
        torch.cuda.empty_cache()
    return errs, out


def fp64_paths_phase(device, static, tet_classic, column):
    """Phase 21: precision.vectors fp64 through build_simulation on every
    path of the port, each held to its bar: cantilever_box GPU vs CPU at tol
    1e-10; the 255^3 cantilever (K1 f64 + K3 f64, 'auto' = classic) against
    8 f32 classic frames; its static solve against phase 16's refined u;
    the 66^3 tet cantilever (K7 + G1 f64) and the soil column (K1 f64, not
    K4 + G2) against their f32 frames; 3 steps of the shuffled 34^3 hex box
    (K7 hex f64); multigrid against block-Jacobi at 96x56x56, tol 1e-10;
    and a one-rank shard (K5 + K3 f64) against the unsharded frames."""
    from civiwave_tpu_torch.config.loader import load_config_from_file
    from civiwave_tpu_torch.parallel.sharding import (
        close_shard_group, make_shard_group, shard_simulation)
    from civiwave_tpu_torch.runner import build_simulation, run_static
    from civiwave_tpu_torch.solver.static import true_relative_residual
    from civiwave_tpu_torch.utils.synthetic import cantilever_config, soil_column_config

    result = {}

    # a. cantilever_box, fp64, tol 1e-10: GPU against CPU
    box_cfg = load_config_from_file(BOX_YAML)
    box_cfg = dataclasses.replace(
        box_cfg,
        precision=dataclasses.replace(box_cfg.precision, vector_precision="fp64"),
        solver=dataclasses.replace(box_cfg.solver, runtime_tolerance=1e-10))
    runs = []
    for dev in (device, torch.device("cpu")):
        reset_f64_counts()
        sim = build_simulation(box_cfg, device=dev)
        tel = sim.run(10)
        runs.append((tel, sim.stepper.state, fp64_path_counts()))
    (tg, sg, cg), (tc, sc, _) = runs
    check_fp64_counts("fp64 cantilever_box", cg, ("keff_f64", "bj_f64"))
    it_g, it_c = [t.pcg_iterations for t in tg], [t.pcg_iterations for t in tc]
    if any(abs(a - b) > 1 for a, b in zip(it_g, it_c)):
        fail(f"fp64 cantilever_box: iterations {it_g} vs CPU {it_c}")
    box_errs = {}
    for name, tol in zip(("displacement", "acceleration"), BOX_F64_TOL):
        _, box_errs[name] = check_close(f"fp64 cantilever_box {name}",
                                        getattr(sg, name).cpu(), getattr(sc, name), tol)
    print(f"fp64 cantilever_box, tol 1e-10, 10 frames GPU vs CPU: iterations {it_g} "
          f"vs {it_c}; converged {[t.pcg_converged for t in tg]}, breakdown "
          f"{[t.pcg_breakdown for t in tg]} (CPU {[t.pcg_breakdown for t in tc]}); "
          f"max abs err / max|CPU| u {box_errs['displacement']:.3e} (tol "
          f"{BOX_F64_TOL[0]:g}), a {box_errs['acceleration']:.3e} (tol "
          f"{BOX_F64_TOL[1]:g}); launches {cg}", flush=True)
    del runs, sg, sc

    # b. the 255^3 cantilever: 8 f32 classic frames, then 8 fp64 frames
    full = dict(tol_runtime=2e-4, max_iters=120, dt=1e-3, adaptive=False,
                mesh={"path": "synthetic://box/%d,%d,%d" % FULL})
    sim = build_simulation(cantilever_config(**full), device=device)
    sim.stepper.solver_variant = "classic"
    tel32, _ = run_frames(sim, 8)
    ref32 = dict(u=sim.stepper.state.displacement.cpu(),
                 a=sim.stepper.state.acceleration.cpu(),
                 iters=[t.pcg_iterations for t in tel32])
    del sim
    torch.cuda.empty_cache()
    sim = build_simulation(cantilever_config(precision=dict(FP64), **full), device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_f64_counts()
    tel, secs = [], []
    for k in range(8):
        t0 = time.perf_counter()
        tel += sim.run(1)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if k == 2:
            third = dict(u=sim.stepper.state.displacement.cpu(),
                         a=sim.stepper.state.acceleration.cpu())
    counts = fp64_path_counts()
    peak = torch.cuda.max_memory_allocated()
    iters = [t.pcg_iterations for t in tel]
    if not all(t.pcg_converged for t in tel):
        fail(f"fp64 255^3: not every frame converged: {iters}")
    if sim.stepper.state.displacement.dtype != torch.float64:
        fail("fp64 255^3: the state is not f64")
    check_fp64_counts("fp64 255^3", counts, ("keff_f64", "bj_f64"))
    # classic: each frame's Rayleigh and residual matvecs, one per iteration
    if counts["keff_f64"] != sum(iters) + 2 * len(iters) or \
            counts["bj_f64"] != sum(iters) + len(iters):
        fail(f"fp64 255^3: {counts} for iterations {iters}")
    if any(abs(a - b) > 1 for a, b in zip(iters, ref32["iters"])):
        fail(f"fp64 255^3: iterations {iters} vs f32 classic {ref32['iters']}")
    e = check_state("fp64 255^3 vs f32 classic", sim.stepper.state, ref32)
    steady = secs[1:]
    full64 = dict(iters=iters, counts=counts, peak=peak,
                  steps_per_s=len(steady) / sum(steady),
                  ms_per_iter=sum(steady) / sum(iters[1:]) * 1e3)
    print(f"fp64 255^3: iterations {iters} (f32 classic {ref32['iters']}); max abs "
          f"err / max|f32| u {e['u']:.3e} (tol {U_TOL:g}), a {e['a']:.3e} (tol "
          f"{A_TOL:g})", flush=True)
    print(f"fp64 255^3: {full64['steps_per_s']:.4f} steps/s, {full64['ms_per_iter']:.4f} "
          f"ms per iteration (frames 2-8, host clock); peak device memory "
          f"{peak / 2**30:.3f} GiB ({peak} bytes); launches {counts}", flush=True)
    profile_window("fp64 255^3 frame 9", lambda: sim.run(1))
    result["full"] = full64
    del sim, ref32
    torch.cuda.empty_cache()

    # c. the static 255^3 solve in fp64 ('auto' = classic), against phase
    # 16's refined u
    sim = build_simulation(cantilever_config(
        max_iters=STATIC_MAX_ITERS, precision=dict(FP64),
        mesh={"path": "synthetic://box/%d,%d,%d" % FULL}), device=device)
    reset_f64_counts()
    t0 = time.perf_counter()
    u, payload = run_static(sim)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = fp64_path_counts()
    if not payload["converged"] or u.dtype != torch.float64:
        fail(f"fp64 static 255^3: converged {payload['converged']} in "
             f"{payload['iterations']} iterations, dtype {u.dtype}")
    check_fp64_counts("fp64 static 255^3", counts, ("keff_f64", "bj_f64"))
    exact = static["exact"]
    dist = float((u - exact).abs().max()) / float(exact.abs().max())
    res = true_relative_residual(sim.model, sim.stepper.external_force, u)
    result["static"] = dict(iterations=payload["iterations"],
                            seconds=payload["elapsed_seconds"], dist=dist, res=res,
                            counts=counts)
    print(f"fp64 static 255^3 (classic): {payload['iterations']} iterations in "
          f"{payload['elapsed_seconds']:.4f} s ({payload['elapsed_seconds'] / payload['iterations'] * 1e3:.4f} "
          f"ms per iteration; f32 classic {static['classic']['iterations']} in "
          f"{static['classic']['seconds']:.4f} s), recurred residual "
          f"{payload['residual_norm']:.3e} of rhs {payload['rhs_norm']:.3e}, true "
          f"relative residual (f64) {res:.3e}; u against classic's u refined twice "
          f"in f64 (phase 16): {dist:.3e} of max|u| (f32 classic "
          f"{static['classic']['err']:.3e}); {total:.3f} s in all; launches "
          f"{counts}", flush=True)
    del sim, u
    torch.cuda.empty_cache()

    # d. the 66^3 tet cantilever (general path) against its f32 frames
    n = GENERAL_N
    sim = build_simulation(cantilever_config(
        mesh={"path": f"synthetic://box/{n},{n},{n},tet"}, dt=1e-3, adaptive=False,
        tol_runtime=2e-4, max_iters=300, precision=dict(FP64)), device=device)
    torch.cuda.synchronize()
    reset_f64_counts()
    tel, secs = run_frames(sim, 8)
    counts = fp64_path_counts()
    iters = [t.pcg_iterations for t in tel]
    if not all(t.pcg_converged for t in tel) or any(
            abs(a - b) > 1 for a, b in zip(iters, tet_classic["iters"])):
        fail(f"fp64 tet 66^3: iterations {iters} vs f32 {tet_classic['iters']}")
    check_fp64_counts("fp64 tet 66^3", counts, ("tet_f64", "g1_f64"))
    te = {}
    for key, tol, got in (("u", U_TOL, sim.stepper.displacement()),
                          ("a", A_TOL, sim.stepper.acceleration())):
        _, te[key] = check_close(f"fp64 tet 66^3 {key}", torch.as_tensor(got),
                                 torch.as_tensor(tet_classic[key]), tol)
    steady = secs[1:]
    result["tet"] = dict(iters=iters, counts=counts,
                         steps_per_s=len(steady) / sum(steady),
                         ms_per_iter=sum(steady) / sum(iters[1:]) * 1e3)
    print(f"fp64 tet 66^3: iterations {iters} (f32 {tet_classic['iters']}); u "
          f"{te['u']:.3e}, a {te['a']:.3e} of max|f32|; {result['tet']['steps_per_s']:.4f} "
          f"steps/s, {result['tet']['ms_per_iter']:.4f} ms per iteration (frames "
          f"2-8); launches {counts}", flush=True)
    profile_window("fp64 tet 66^3 frame 9", lambda: sim.run(1))
    del sim
    torch.cuda.empty_cache()

    # e. the soil column: the slender route is f32 only, so fp64 takes K1
    sim = build_simulation(soil_column_config(cells=COLUMN, precision=dict(FP64)),
                           device=device)
    reset_f64_counts()
    tel, secs = run_frames(sim, 8)
    counts = fp64_path_counts()
    iters = [t.pcg_iterations for t in tel]
    if not all(t.pcg_converged for t in tel) or any(
            abs(a - b) > 1 for a, b in zip(iters, column["iters"])):
        fail(f"fp64 soil column: iterations {iters} vs f32 {column['iters']}")
    check_fp64_counts("fp64 soil column", counts, ("keff_f64", "bj_f64"))
    ce = check_state("fp64 soil column vs f32 (K4 + G2)", sim.stepper.state, column)
    steady = secs[1:]
    result["column"] = dict(iters=iters, steps_per_s=len(steady) / sum(steady),
                            ms_per_iter=sum(steady) / sum(iters[1:]) * 1e3)
    print(f"fp64 soil column: iterations {iters} (f32 {column['iters']}); u "
          f"{ce['u']:.3e}, a {ce['a']:.3e} of max|f32|; {result['column']['steps_per_s']:.4f} "
          f"steps/s (f32 {column['steps_per_s']:.4f}), {result['column']['ms_per_iter']:.4f} "
          f"ms per iteration; launches {counts}", flush=True)
    del sim
    torch.cuda.empty_cache()

    # f. 3 steps of the shuffled 34^3 hex box (general_steps_per_s's
    # workload) in fp64: K7 hex f64
    from civiwave_tpu_torch.physics import materials
    from civiwave_tpu_torch.solver.stepper import effective_scalars, newmark_step
    from civiwave_tpu_torch.utils.synthetic import box_mesh, shuffle_mesh_nodes

    hcfg = cantilever_config()
    model, force, _ = packed_model(
        shuffle_mesh_nodes(box_mesh(34, 34, 34, hex_elements=True), seed=5),
        hcfg, device, pad_nodes=1024, pad_elems=1024)
    ray = materials.compute_rayleigh(hcfg.damping)
    pc = model.build_preconditioner(*effective_scalars(
        1.0e-3, ray.alpha, ray.beta, vector_precision="fp64"))
    reset_f64_counts()
    state, hiters = model.zero_state(), []
    t0 = time.perf_counter()
    for _ in range(3):
        step = newmark_step(model, state, force, 1.0e-3, 2.0e-4, 120,
                            rayleigh_alpha=ray.alpha, rayleigh_beta=ray.beta,
                            preconditioner=pc, vector_precision="fp64")
        state = step.state
        if not step.pcg.converged:
            fail(f"fp64 hex 34^3: a step did not converge ({step.pcg})")
        hiters.append(step.pcg.iterations)
    torch.cuda.synchronize()
    hex_s = time.perf_counter() - t0
    counts = fp64_path_counts()
    check_fp64_counts("fp64 hex 34^3", counts, ("hex_f64", "g1_f64"))
    check_state("fp64 hex 34^3", state)
    result["hex"] = dict(iters=hiters, counts=counts)
    print(f"fp64 shuffled hex 34^3: 3 steps, iterations {hiters}, "
          f"{3 / hex_s:.4f} steps/s (first step included); launches {counts}",
          flush=True)
    del model, force, pc, state
    torch.cuda.empty_cache()

    # g. multigrid against block-Jacobi at 96x56x56, tol 1e-10, 3 frames
    ab = {}
    for label, pre in (("multigrid", "multigrid"), ("block-Jacobi", "block_jacobi")):
        sim = build_simulation(cantilever_config(
            dt=1e-3, adaptive=False, precision=dict(FP64),
            mesh={"path": "synthetic://box/%d,%d,%d" % MG_AB},
            solver=solver_node(preconditioner=pre, tol_runtime=1e-10)), device=device)
        reset_f64_counts()
        tel, secs = run_frames(sim, 3)
        counts = fp64_path_counts()
        check_fp64_counts(f"fp64 {label} 96x56x56", counts, ("keff_f64",))
        ab[label] = (tel, sim.stepper.state.displacement.cpu(), counts, sum(secs))
        del sim
    (tm, um, cm, sm), (tb, ub, cb, sb) = ab["multigrid"], ab["block-Jacobi"]
    if cb["bj_f64"] <= 0 or cm["bj_f64"]:
        fail(f"fp64 multigrid A/B: K3 f64 launches {cm['bj_f64']} / {cb['bj_f64']}")
    _, mg_err = check_close("fp64 multigrid vs block-Jacobi u", um, ub, MG_F64_TOL)
    result["mg"] = dict(iters=[t.pcg_iterations for t in tm],
                        bj_iters=[t.pcg_iterations for t in tb], err=mg_err)
    print(f"fp64 multigrid vs block-Jacobi, 96x56x56, tol 1e-10, 3 frames: "
          f"iterations {result['mg']['iters']} vs {result['mg']['bj_iters']}, "
          f"{sm:.3f} vs {sb:.3f} s; converged {[t.pcg_converged for t in tm]} / "
          f"{[t.pcg_converged for t in tb]}; u {mg_err:.3e} of max|u| (tol "
          f"{MG_F64_TOL:g}); multigrid K1 f64 {cm['keff_f64']}", flush=True)
    del ab, um, ub

    # h. a one-rank shard, fp64, classic: 3 frames against the unsharded
    # fp64 frames of b (classic too)
    sim = shard_simulation(build_simulation(cantilever_config(
        precision=dict(FP64), **full), device=device), make_shard_group(1, device))
    sim.stepper.solver_variant = "classic"
    reset_f64_counts()
    tel = sim.run(3)
    counts = fp64_path_counts()
    iters = [t.pcg_iterations for t in tel]
    check_fp64_counts("fp64 shard", counts, ("k5_f64", "bj_f64"))
    if any(abs(a - b) > 1 for a, b in zip(iters, full64["iters"])):
        fail(f"fp64 shard: iterations {iters} vs unsharded {full64['iters'][:3]}")
    se = check_state("fp64 shard vs unsharded", sim.stepper.state, third)
    result["shard"] = dict(iters=iters, counts=counts)
    print(f"fp64 one-rank shard (classic, overlap split): iterations {iters} "
          f"(unsharded {full64['iters'][:3]}); u {se['u']:.3e}, a {se['a']:.3e} of "
          f"max|unsharded|; launches {counts}", flush=True)
    del sim
    close_shard_group()
    torch.cuda.empty_cache()
    return result


def checkpoint_phase(device):
    """Phase 22: checkpoint and resume at 255^3 ('auto' = fused, f32): 6
    frames saving every 3, then a fresh build_simulation restores the
    checkpoint of frame 3 and runs to the same end; u, v, a and the warm
    start bit for bit, dt, clock and frame equal.  The files are removed."""
    import shutil

    from civiwave_tpu_torch.runner import build_simulation
    from civiwave_tpu_torch.utils.checkpoint import CheckpointManager
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    cfg = cantilever_config(tol_runtime=2e-4, max_iters=120, dt=1e-3, adaptive=False,
                            mesh={"path": "synthetic://box/%d,%d,%d" % FULL})
    tmp = scratch_dir("checkpoint")
    try:
        manager = CheckpointManager(tmp)
        unbroken = build_simulation(cfg, device=device)
        tel = unbroken.run(6, checkpoint_manager=manager, checkpoint_every=3)
        manager.wait()
        if manager.steps() != [4]:
            fail(f"checkpoint 255^3: saved steps {manager.steps()}, expected [4]")
        size = os.path.getsize(manager.path(4))
        # one synchronous save of the end state, timed on the host clock
        # (the device-to-host copies and the write)
        t0 = time.perf_counter()
        unbroken.stepper.save_checkpoint(manager, wait=True)
        save_s = time.perf_counter() - t0
        resumed = build_simulation(cfg, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = resumed.stepper.restore_checkpoint(manager, 4)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        rest = resumed.run(2)
        a, b = unbroken.stepper, resumed.stepper
        same = {name: torch.equal(getattr(a.state, name), getattr(b.state, name))
                for name in ("displacement", "velocity", "acceleration", "warm_x")}
        if frame != 4 or not all(same.values()) or (
                a.current_dt, a.accumulated_time, a.frame_index) != (
                b.current_dt, b.accumulated_time, b.frame_index):
            fail(f"checkpoint 255^3: the resumed run differs: {same}, frames "
                 f"{a.frame_index}/{b.frame_index}")
        print(f"checkpoint 255^3: 6 fused frames {[t.pcg_iterations for t in tel]}, "
              f"resumed at frame 4 for {[t.pcg_iterations for t in rest]}: u, v, a "
              f"and warm_x bit-equal, dt/clock/frame equal; a checkpoint {size:,} "
              f"bytes, save {save_s:.3f} s (wait), restore {restore_s:.3f} s",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del unbroken, resumed
    torch.cuda.empty_cache()
    return dict(bytes=size, save_s=save_s, restore_s=restore_s)


def profile_cli_phase():
    """Phase 23: ``--profile DIR`` through runner.main on cantilever_box on
    the card: the Chrome trace names the reference's ranges and holds K2's
    or K1's device events.  The trace is removed."""
    import shutil

    from civiwave_tpu_torch.runner import main as runner_main

    tmp = scratch_dir("profile")
    try:
        rc = runner_main([BOX_YAML, "--frames", "3", "--quiet", "--profile", tmp])
        traces = [os.path.join(tmp, f) for f in os.listdir(tmp)]
        if rc != 0 or len(traces) != 1:
            fail(f"--profile: rc {rc}, traces {traces}")
        with open(traces[0], encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        names = {}
        for e in events:
            names[e.get("name", "")] = names.get(e.get("name", ""), 0) + 1
        ranges = {n: names.get(n, 0) for n in (
            "newmark_predictor", "effective_rhs", "pcg_solve", "newmark_update",
            "pcg_pc_matvec", "pcg_pc_matvec_dots", "pcg_matvec")}
        kernels = sum(1 for e in events if e.get("cat") == "kernel"
                      and "sweep_kernel" in e.get("name", ""))
        if not all(ranges[n] for n in ("newmark_predictor", "effective_rhs",
                                        "pcg_solve", "newmark_update",
                                        "pcg_pc_matvec_dots")) or not kernels:
            fail(f"--profile: ranges {ranges}, K1/K2 device events {kernels}")
        print(f"--profile (cantilever_box, 3 frames on the card): "
              f"{os.path.getsize(traces[0]):,} bytes, {len(events):,} events; "
              f"ranges {ranges}; K1/K2 device events {kernels}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --- the multi-device remainder, part 1 (phases 24-28) -----------------------

GENERAL_SHARDS = (4, 8)  # phase 24's in-process cuts


def general_shard_counts():
    """K7/G1 launches and the collectives' calls (phase 25)."""
    from civiwave_tpu_torch.parallel import collectives

    return {**general_counts(), "ppermute": collectives.ppermute.calls,
            "psum": collectives.psum.calls,
            "psum_f64_3": collectives.psum.shapes[(torch.float64, (3,))],
            "psum_f64_4": collectives.psum.shapes[(torch.float64, (4,))],
            "all_gather": collectives.all_gather.calls}


def reset_general_shard_counts():
    from civiwave_tpu_torch.parallel import collectives

    reset_general_counts()
    collectives.reset_counts()


def local_windows(shards, x):
    """Each in-process shard's inputs for a whole-model x: its (L, 3) rows
    and the next shard's first G sanitized rows (zero past the end; None
    when G = 0), as the group's first exchange delivers them."""
    out = []
    for shard in shards:
        L, G, r0 = shard.local_rows, shard.halo_ghost, shard.shard_row0
        ghost = None
        if G:
            nxt = x[r0 + L:r0 + L + G]
            ghost = x.new_zeros((G, 3))
            ghost[:nxt.shape[0]] = nxt
            ghost = torch.where(shard.shard_window.bc_mask[L:], 0.0, ghost)
        out.append((shard.own_rows(x), ghost))
    return out


def local_keff_general(shards, x, stiffness_scale, mass_factor):
    """K_eff * x of every in-process shard of one halo cut
    (``parallel.sharding.local_general_shards``, no group) for a
    whole-model x, the two exchanges made by slicing: each shard's (L, 3)
    rows, in shard order (the tests hold the port's shards with it too)."""
    from civiwave_tpu_torch.ops.apply_keff import add_dashpot_term
    from civiwave_tpu_torch.ops.general_sharded import (
        add_ghost_partials, window_keff)

    windows = local_windows(shards, x)
    outs_ext = [window_keff(shard, part, ghost, stiffness_scale, mass_factor)
                for shard, (part, ghost) in zip(shards, windows)]
    outs = []
    for s, shard in enumerate(shards):
        recv = None
        if s and shard.halo_ghost:
            recv = outs_ext[s - 1][shard.local_rows:]
        out = add_ghost_partials(shard, outs_ext[s], recv)
        outs.append(add_dashpot_term(shard, out, windows[s][0]))
    return outs


def general_halo_phase(device, ss, mf):
    """Phase 24: phase 8's 66^3 tet cantilever and the 66^3 hex box cut
    into 4 and 8 shards in this process (``local_general_shards``, no
    group): L, G and E_s; each shard's K7 on its (L + G)-row window and G1
    over its L + G rows against the plain versions (G1 bit-equal); the
    combined shards (``local_keff_general``) against the unsharded K7 +
    G1 at OP_TOL, and whether the rows off the ghost bands are bit-equal;
    K7 + G1 per shard timed beside the unsharded call."""
    from civiwave_tpu_torch.ops import apply_keff as gops
    from civiwave_tpu_torch.ops import general_sharded as gsh
    from civiwave_tpu_torch.ops.cuda import assemble_csr as g1
    from civiwave_tpu_torch.ops.cuda import element_forces as k7
    from civiwave_tpu_torch.parallel.sharding import local_general_shards
    from civiwave_tpu_torch.runner import build_simulation
    from civiwave_tpu_torch.utils.synthetic import box_mesh, cantilever_config

    n = GENERAL_N
    tet = build_simulation(cantilever_config(
        mesh={"path": f"synthetic://box/{n},{n},{n},tet"}), device=device).model
    hexm, _, _ = packed_model(box_mesh(n, n, n, hex_elements=True),
                              cantilever_config(), device, pad_nodes=1024,
                              pad_elems=1024)
    worst, times = (0.0, 0.0), {}
    for model in (tet, hexm):
        block = "tet" if model.padded_tet_count else "hex"
        label = f"{block} {n}^3"
        wrapper = (k7.tet_element_forces if block == "tet"
                   else k7.hex_element_forces)
        x = random_vector(model, device)
        ref = gops.apply_keff(model, x, ss, mf)
        whole_ms = time_ms(lambda: gops.apply_keff(model, x, ss, mf), 20)
        for n_shards in GENERAL_SHARDS:
            t0 = time.perf_counter()
            shards = local_general_shards(model, n_shards)
            torch.cuda.synchronize()
            cut_s = time.perf_counter() - t0
            L, G, E = (shards[0].local_rows, shards[0].halo_ghost,
                       shards[0].halo_elems)
            windows = local_windows(shards, x)
            for s, (shard, (part, ghost)) in enumerate(zip(shards, windows)):
                w = shard.shard_window
                xw = gsh.window_x(part, ghost)
                err = check_close(f"K7 {block} {label} shard {s}/{n_shards}",
                                  wrapper(w, xw, ss),
                                  k7.element_forces_plain(w, xw, ss, block), OP_TOL)
                worst = max(worst, err, key=lambda e: e[1])
                rows = k7.element_force_rows(w, xw, ss)
                out = g1.assemble_keff(w, rows, xw, mf)
                if not torch.equal(out, g1.assemble_keff_plain(w, rows, xw, mf)):
                    fail(f"G1 {label} shard {s}/{n_shards}: not bit-equal to "
                         f"the plain version")
            got = torch.cat(local_keff_general(shards, x, ss, mf))
            err = check_close(f"{label} over {n_shards} shards", got, ref, OP_TOL)
            worst = max(worst, err, key=lambda e: e[1])
            off = torch.ones(model.padded_node_count, dtype=torch.bool,
                             device=device)
            for s in range(1, n_shards):
                off[s * L:s * L + G] = False
            off_equal = torch.equal(got[off], ref[off])
            shard_ms = [time_ms(lambda sh=sh, p=p, g=g: gsh.window_keff(
                sh, p, g, ss, mf), 20) for sh, (p, g) in zip(shards, windows)]
            times[(block, n_shards)] = dict(max_ms=max(shard_ms),
                                            mean_ms=float(np.mean(shard_ms)),
                                            whole_ms=whole_ms)
            print(f"general halo cut [{label} over {n_shards} shards]: L {L:,}, "
                  f"G {G:,}, E_s {E:,} (cut in {cut_s:.3f} s); combined vs "
                  f"unsharded abs/rel err {err[0]:.3e}/{err[1]:.2e}; rows off "
                  f"the ghost bands bit-equal: {off_equal}; K7 + G1 per shard "
                  f"{np.mean(shard_ms):.4f} ms mean, {max(shard_ms):.4f} max "
                  f"(CUDA events; unsharded K7 + G1 {whole_ms:.4f} ms)",
                  flush=True)
            del shards, windows, got
        del x, ref
    del tet, hexm
    torch.cuda.empty_cache()
    return worst, times


def general_sharded_main_path_phase(device, tet_classic):
    """Phase 25: phase 8's 66^3 tet cantilever through build_simulation
    and shard_simulation over a one-rank NCCL group (the single-device K7
    + G1 operator with the group's reductions; 'auto' = classic, as the
    reference's unmarked one-device model): 8 frames against phase 8's
    (iterations +-1, u and a at the stepping tolerances), K7 and G1 once
    per matvec; frame 9 profiled; then 3 fused frames, one f64 (3,)
    all-reduce per iteration, no exchange and no all-gather."""
    from civiwave_tpu_torch.parallel.sharding import (
        close_shard_group, make_shard_group, shard_simulation)
    from civiwave_tpu_torch.runner import build_simulation
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    n = GENERAL_N
    cfg = cantilever_config(
        mesh={"path": f"synthetic://box/{n},{n},{n},tet"}, dt=1e-3,
        adaptive=False, tol_runtime=2e-4, max_iters=300,
    )
    sim = shard_simulation(build_simulation(cfg, device=device),
                           make_shard_group(1, device))
    torch.cuda.synchronize()
    reset_general_shard_counts()
    frame_s, tel = [], []
    for _ in range(8):
        t0 = time.perf_counter()
        tel += sim.run(1)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    counts = general_shard_counts()
    iters = [t.pcg_iterations for t in tel]
    if not all(t.pcg_converged for t in tel) or any(
            abs(a - b) > 1 for a, b in zip(iters, tet_classic["iters"])):
        fail(f"general one-rank shard: iterations {iters} against phase 8's "
             f"{tet_classic['iters']}")
    matvecs = 2 * len(iters) + sum(iters)
    if (counts["element_forces_tet"], counts["assemble_csr"]) != (matvecs, matvecs) \
            or counts["ppermute"] or counts["all_gather"]:
        fail(f"general one-rank shard: counts {counts}, {matvecs} matvecs")
    errs = {}
    for name, key, tol in (("displacement", "u", U_TOL),
                           ("acceleration", "a", A_TOL)):
        got = torch.from_numpy(getattr(sim.stepper, name)())
        _, errs[key] = check_close(f"general one-rank shard {name}", got,
                                   torch.from_numpy(tet_classic[key]), tol)
    steady = frame_s[1:]
    # the host cost of one all-reduce of an f64 (3,) partial on this group
    # of one rank (each classic dot makes one)
    group = sim.model.shard_group
    partial = torch.zeros(3, dtype=torch.float64, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        group.psum(partial)
    torch.cuda.synchronize()
    psum_ms = (time.perf_counter() - t0) * 10
    print(f"general one-rank shard ({n}^3 tet, classic): pcg iterations {iters} "
          f"(phase 8 {tet_classic['iters']}); max abs err / max|phase 8| u "
          f"{errs['u']:.3e}, a {errs['a']:.3e}; steps/s "
          f"{len(steady) / sum(steady):.4f} (frames 2-8; phase 8 unsharded "
          f"{tet_classic['steps_per_s']:.4f}); one f64 (3,) all-reduce on the "
          f"one-rank group {psum_ms:.4f} ms (host clock, 100 calls); counts "
          f"{counts}", flush=True)
    # where its frames go, beside phase 8's "general main path frame 9"
    profile_window("general one-rank shard frame 9", lambda: sim.run(1))
    sim.stepper.solver_variant = "fused"
    reset_general_shard_counts()
    tel3 = sim.run(3)
    counts3 = general_shard_counts()
    it3 = [t.pcg_iterations for t in tel3]
    want = dict(psum_f64_3=sum(it3), psum_f64_4=3, ppermute=0, all_gather=0)
    if not all(t.pcg_converged for t in tel3) or any(
            counts3[k] != v for k, v in want.items()):
        fail(f"general one-rank shard fused: iterations {it3}, counts "
             f"{counts3}, expected {want}")
    print(f"general one-rank shard, 3 fused frames: iterations {it3}; one f64 "
          f"(3,) all-reduce per iteration; counts {counts3}", flush=True)
    del sim
    close_shard_group()
    torch.cuda.empty_cache()
    return dict(counts=counts, counts_fused=counts3)


def sharded_basin_phase(device, basin):
    """Phase 26: phase 13's 255^3 basin (five absorbing faces) over a
    one-rank 1-D group and a one-rank 2-D group, 4 frames each, against
    phase 13's (iterations +-1, u and a at the stepping tolerances; K5 and
    K3, never K1, K2 or K6); then, in this process, the face terms of 4
    slabs and 2x2 tiles against the global term, bit for bit."""
    from civiwave_tpu_torch.config.loader import load_config_from_file
    from civiwave_tpu_torch.ops import structured as sops
    from civiwave_tpu_torch.parallel.sharding import (
        close_shard_group, cut_block, local_tiles, make_shard_group,
        make_shard_group_2d, shard_simulation)
    from civiwave_tpu_torch.runner import build_simulation

    cfg = dataclasses.replace(load_config_from_file(BASIN),
                              mesh_path="synthetic://box/%d,%d,%d" % FULL)
    counts_1d = None
    for label, make in (("1-D", lambda: make_shard_group(1, device)),
                        ("2-D", lambda: make_shard_group_2d(1, 1, device))):
        sim = shard_simulation(build_simulation(cfg, device=device), make())
        reset_sharded_counts()
        t0 = time.perf_counter()
        tel = sim.run(4)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = sharded_counts()
        iters = [t.pcg_iterations for t in tel]
        if not all(t.pcg_converged for t in tel) or any(
                abs(a - b) > 1 for a, b in zip(iters, basin["iters"])):
            fail(f"sharded basin {label}: iterations {iters} against phase "
                 f"13's {basin['iters']}")
        if counts["k5"] <= 0 or counts["bj"] <= 0 or counts["keff"] or \
                counts["pc"] or counts["k6"]:
            fail(f"sharded basin {label}: wrong kernels {counts}")
        errs = {}
        for name, key, tol in (("displacement", "u", U_TOL),
                               ("acceleration", "a", A_TOL)):
            _, errs[key] = check_close(
                f"sharded basin {label} {name}",
                getattr(sim.stepper.state, name).cpu(), basin[key], tol)
        print(f"sharded basin 255^3 ({label}, one rank): pcg iterations {iters} "
              f"(phase 13 {basin['iters']}); max abs err / max|phase 13| u "
              f"{errs['u']:.3e}, a {errs['a']:.3e}; 4 frames {seconds:.3f} s; "
              f"counts {counts}", flush=True)
        counts_1d = counts_1d or counts
        del sim
        torch.cuda.empty_cache()
    close_shard_group()

    # (255^3 needs no padding; a smaller grid is padded to divide the cuts)
    model = build_simulation(cfg, device=device, pad_x_multiple=4,
                             pad_y_multiple=2).model
    x = random_vector(model, device)
    ref = sops.absorbing_force_structured(model, x)
    for shape, two_d in (((4, 1), False), ((2, 2), True)):
        for tile in local_tiles(model, shape, two_d):
            cut = (tile.x0, tile.y0, *tile.local_extent)
            got = sops.absorbing_force_structured(tile, cut_block(x, *cut))
            if not torch.equal(got, cut_block(ref, *cut)):
                fail(f"face terms of tile ({tile.x0}, {tile.y0}) of "
                     f"{shape}: not the global term's block")
            del tile, got
        print(f"face terms of the 255^3 basin on {shape[0]}x{shape[1]} "
              f"{'tiles' if two_d else 'slabs'}: equal to the global term's "
              f"blocks, bit for bit", flush=True)
    del model, x, ref
    torch.cuda.empty_cache()
    return dict(counts=counts_1d)


def sharded_static_phase(device, static):
    """Phase 27: the 255^3 static cantilever, classic, on a one-rank 1-D
    shard (K5 + K3) through run_static, against phase 16's refined u
    (within 2.5e-4 of max|u|), its iterations beside phase 16's."""
    from civiwave_tpu_torch.parallel.sharding import (
        close_shard_group, make_shard_group, shard_simulation)
    from civiwave_tpu_torch.runner import build_simulation, run_static
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    cfg = cantilever_config(max_iters=STATIC_MAX_ITERS,
                            mesh={"path": "synthetic://box/%d,%d,%d" % FULL})
    sim = shard_simulation(build_simulation(cfg, device=device),
                           make_shard_group(1, device))
    reset_sharded_counts()
    u, payload = run_static(sim, variant="classic")
    torch.cuda.synchronize()
    counts = sharded_counts()
    if not payload["converged"] or not bool(torch.isfinite(u).all()):
        fail(f"sharded static 255^3: not converged in {payload['iterations']} "
             f"iterations")
    if counts["k5"] <= 0 or counts["bj"] <= 0 or counts["keff"] or counts["pc"]:
        fail(f"sharded static 255^3: wrong kernels {counts}")
    exact = static["exact"]
    err = float((u.double() - exact).abs().max()) / float(exact.abs().max())
    if not err <= U_TOL:
        fail(f"sharded static 255^3: u {err:.3e} of max|u| from the refined "
             f"solution > {U_TOL:g}")
    print(f"sharded static 255^3 (classic, one rank): {payload['iterations']} "
          f"iterations in {payload['elapsed_seconds']:.4f} s (phase 16 classic "
          f"{static['classic']['iterations']} in {static['classic']['seconds']:.4f} "
          f"s); u {err:.3e} of max|u| from phase 16's refined u (tol {U_TOL:g}); "
          f"counts {counts}", flush=True)
    del sim, u
    close_shard_group()
    torch.cuda.empty_cache()
    return dict(counts=counts, iterations=payload["iterations"],
                seconds=payload["elapsed_seconds"], err=err)


def launch_across_gpus_phase():
    """Phase 28: with two or more GPUs, ``parallel.launch
    --against-one-rank`` over 2 ranks on the 66^3 tet cantilever (the
    halo operator, rank 0's profile summaries of both runs printed) and
    examples/seismic_basin.yaml (absorbing slabs); a failed check fails
    the run.  With one GPU it prints that it skipped."""
    count = torch.cuda.device_count()
    if count < 2:
        print(f"launch across 2 GPUs: skipped ({count} GPU visible)", flush=True)
        return
    import shutil
    import tempfile

    n = GENERAL_N
    traces = tempfile.mkdtemp(prefix="civiwave_traces_")
    for label, args in (
        (f"tet cantilever {n}^3", ["--cells", f"{n},{n},{n},tet", "--frames",
                                   "4", "--profile", traces]),
        ("seismic basin", ["--scenario", BASIN, "--frames", "4"]),
    ):
        proc = subprocess.run(
            [sys.executable, "-m", "civiwave_tpu_torch.parallel.launch",
             "--npx", "2", *args, "--against-one-rank", "--timeout", "240"],
            capture_output=True, text=True, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith(("against one rank", "2 rank", "1 rank",
                                   "profile summary"))]
        print(f"launch across 2 GPUs [{label}]: rc {proc.returncode}; " +
              " | ".join(lines), flush=True)
        if proc.returncode != 0:
            fail(f"launch across 2 GPUs [{label}]: {proc.stderr[-2000:]}")
    shutil.rmtree(traces, ignore_errors=True)
    launch_output_check("cuda")


def launch_output_check(device_name, cells="63,63,63", frames=4):
    """Phase 28b: ``parallel.launch --output --checkpoint-dir`` over 2 ranks
    and over 1 (``device_name``'s backend): the same files, their VTU
    arrays at the stepping tolerances; the 2-rank run's last checkpoint
    restores into the unsharded build padded for 2 ranks and equals its
    last VTU's displacement bit for bit."""
    import argparse
    import shutil

    from civiwave_tpu_torch.parallel.launch import _scenario
    from civiwave_tpu_torch.runner import build_simulation
    from civiwave_tpu_torch.utils.checkpoint import CheckpointManager

    label = f"launch --output --checkpoint-dir cantilever {cells}"
    tmp = scratch_dir("launch_output")
    try:
        dirs = {}
        for npx in (2, 1):
            out, ck = (os.path.join(tmp, f"{k}{npx}") for k in ("out", "ck"))
            proc = subprocess.run(
                [sys.executable, "-m", "civiwave_tpu_torch.parallel.launch",
                 "--npx", str(npx), "--cells", cells, "--frames", str(frames),
                 "--device", device_name, "--output", out, "--checkpoint-dir",
                 ck, "--checkpoint-every", "2", "--timeout", "240"],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                fail(f"{label} over {npx} rank(s): {proc.stderr[-2000:]}")
            rate = [ln for ln in proc.stdout.splitlines() if "steps/s" in ln]
            print(f"{label} over {npx} rank(s): " + " | ".join(rate), flush=True)
            dirs[npx] = (out, ck)
        identical, worst = compare_output_dirs(f"{label} 2 ranks vs 1",
                                               dirs[2][0], dirs[1][0])
        ns = argparse.Namespace(scenario=None, cells=cells, static=False)
        sim = build_simulation(_scenario(ns), device=device_name,
                               pad_x_multiple=2)
        manager = CheckpointManager(dirs[2][1])
        if manager.steps() != [frames - 1, frames]:
            fail(f"{label}: checkpoints {manager.steps()}")
        sim.stepper.restore_checkpoint(manager)
        u = sim.model.to_nodal(sim.stepper.state.displacement).cpu().numpy()
        vtu = read_vtu(os.path.join(dirs[2][0], "vtu", f"frame_{frames - 1:05d}.vtu"),
                       ["displacement"])[1]["displacement"]
        if not np.array_equal(u.reshape(-1), vtu):
            fail(f"{label}: the checkpoint's u is not the last VTU's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"{label}: 2 ranks against 1: the same files, byte-identical "
          f"{identical}, worst {worst:.3e} of max|.|; the 2-rank checkpoint "
          f"restores into the unsharded build and equals the last VTU's u",
          flush=True)


# --- heterogeneous grids (A1): G3, the corner gather ---------------------

HETERO_BOX = (16, 4, 4)  # phase 29's GPU-vs-CPU box
HETERO_FRAMES = 8
# PCG iterations of those 8 frames as measured on an H100 (PERF.md):
# each frame must land within 1 of them
HETERO_ITERS = (44, 39, 35, 32, 29, 27, 25, 22)
HETERO_STATIC_TOL = 1e-6
# cells and build options of the small heterogeneous grids G3 is held to
# its plain version on (phase 29; tests/test_torch_kernels_cuda.py's HETERO
# and the CPU tests of its tables and sweep): grids that cut G3's 8 x 32
# (y, z) node tiles, its 9 x 33 cell tiles and its 32-plane X chunks
G3_SHAPES = {
    # X = 33 (1 mod 32): the last chunk holds one plane
    "x_1_mod_32": ((32, 5, 7), {}),
    # a padded X, a dead +Y row, fixes on several faces
    "xpad4": ((6, 5, 4), dict(pad_x_multiple=4)),
    "ypad_row": ((5, 5, 3), dict(pad_y_multiple=4)),
    "odd_partial_fixes": ((17, 9, 33), dict(fixes=[
        ("x0", (True, True, True), (None, None, None)),
        ("y1", (False, True, False), (None, None, None)),
        ("z0", (True, False, True), (1e-3, None, None)),
    ])),
    # Y = 13 (not a multiple of 8), Z = 37 (not a multiple of 4 or 32):
    # two y and two z tiles, both ragged
    "y13_z37": ((7, 12, 36), {}),
    # X = 65 over three chunks, the last of one plane; a dead +Y row
    "x65_dead_row": ((64, 4, 4), dict(pad_y_multiple=2)),
    # one cell thick along each axis
    "one_cell_x": ((1, 6, 9), {}),
    "one_cell_y": ((6, 1, 9), {}),
    "one_cell_z": ((6, 9, 1), dict(fixes=[
        ("z1", (True, False, True), (None, None, None)),
    ])),
}
# least bytes per node of G3: x and out (f32 12 B each, f64 24 B), the
# stored mass (4 B) and the mask (3 B), plus lam and mu (4 B each) per
# live cell; least operations: per node and live incident cell, the node's
# 3 rows of lam A + mu B times the cell's 24 corner values, 2 x 72
# multiply-adds, counted over the nodes that are not fully constrained
G3_BYTES_PER_NODE = {torch.float32: 31, torch.float64: 55}
G3_FLOPS_PER_PAIR = 288
# G3's products are a matrix product (each cell's 24 corner values times
# the 48 x 24 table [A; B]): the H100 SXM's published f64 tensor-core rate,
# equal to its f32 rate outside the tensor cores
F64_MATRIX_TFLOPS = 67.0


def g3_counts():
    from civiwave_tpu_torch.ops.cuda import corner_gather as g3

    return {"g3": g3.apply_keff_corner_gather.launches,
            "g3_f64": g3.apply_keff_corner_gather.launches_f64}


def reset_g3_counts():
    from civiwave_tpu_torch.ops.cuda import corner_gather as g3

    g3.apply_keff_corner_gather.launches = 0
    g3.apply_keff_corner_gather.launches_f64 = 0


def hetero_path_counts():
    """G3's counters, every structured and slender kernel's, and the f64
    instances' (only G3's may move on a heterogeneous path)."""
    return {**g3_counts(), **all_counts(), **f64_counts()}


def check_hetero_counts(label, counts, want):
    """``want`` (a G3 instance) launched, every other kernel never."""
    others = {k: v for k, v in counts.items() if k != want and v}
    if counts[want] <= 0 or others:
        fail(f"{label}: {want} launched {counts[want]} times, other kernels "
             f"{others}")


def hetero_cells(dims, seed=SEED):
    """Per-cell lam0 (1 + U), mu0 (1 + U') of the steel cantilever, U and U'
    uniform on [0, 1) from ``default_rng(seed)`` (the reference's own
    heterogeneous case, at full width)."""
    from civiwave_tpu_torch.physics import materials
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    lame = materials.make_properties(cantilever_config().materials[0]).lame
    rng = np.random.default_rng(seed)
    return (lame.lam * (1.0 + rng.uniform(0.0, 1.0, dims)),
            lame.mu * (1.0 + rng.uniform(0.0, 1.0, dims)))


def hetero_model(dims, device, lam_mu=None, **options):
    """The steel cantilever (x0 fixed, traction -1e6 Pa on x1) of ``dims``
    cells with per-cell materials, through ``build_structured_model``
    (``options``: its padding and fixes)."""
    from civiwave_tpu_torch.mesh.structured import build_structured_model
    from civiwave_tpu_torch.physics import materials
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    mat = cantilever_config().materials[0]
    lam, mu = hetero_cells(dims) if lam_mu is None else lam_mu
    model, force = build_structured_model(
        *dims, materials.make_properties(mat), mat.density,
        traction=(0.0, 0.0, -1.0e6), lam_grid=lam, mu_grid=mu, device=device,
        **options)
    if model.homogeneous:
        fail(f"heterogeneous {dims}: build_structured_model made a homogeneous grid")
    return model, force


def hetero_stepper(model, force, precision="fp32"):
    from civiwave_tpu_torch.physics import materials
    from civiwave_tpu_torch.solver.stepper import NewmarkStepper
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    cfg = cantilever_config(tol_runtime=2e-4, max_iters=120, dt=1e-3,
                            adaptive=False)
    ray = materials.compute_rayleigh(cfg.damping)
    return NewmarkStepper(model, model.zero_state(), force, ray, cfg.solver,
                          cfg.time, vector_precision=precision)


def g3_composition(model, x, stiffness_scale, mass_factor):
    """G3's torch-composition yardstick (never on the path): the 8 corner
    views of xs stacked into a (24, cells) matrix, one ``torch.matmul``
    with the packed (48, 24) [A; B] (cuBLAS; f64 on the tensor cores), the
    rows scaled by lam and mu, the 8 corner slices added back, then the
    envelope of the plain version."""
    from civiwave_tpu_torch.mesh.structured import CORNERS
    from civiwave_tpu_torch.ops import structured as ops
    from civiwave_tpu_torch.ops.cuda import corner_gather as g3

    nx, ny, nz = model.nx, model.ny, model.nz
    packed = torch.as_tensor(g3.packed_tables(model.spacing, x.dtype),
                             device=x.device)
    xs = x.masked_fill(model.bc_mask, 0.0)
    u = torch.stack(ops.corner_views(model, xs), dim=1).reshape(24, -1)
    d = torch.matmul(packed, u)
    lam = model.lam_cells.reshape(-1).to(x.dtype)
    mu = model.mu_cells.reshape(-1).to(x.dtype)
    f = (d[:24] * lam + d[24:] * mu).reshape(3, 8, nx, ny, nz)
    stiff = torch.zeros_like(x)
    for l, (di, dj, dk) in enumerate(CORNERS):
        stiff[:, di:di + nx, dj:dj + ny, dk:dk + nz] += f[:, l]
    return ops.keff_envelope(model, x, xs, stiff, stiffness_scale, mass_factor)


def g3_least(model, dtype):
    """(least ms, bound_by) of one G3 call on ``model``: the bytes above
    and the operations of this grid's (node, live cell) pairs."""
    X, Y, Z = model.grid_shape
    nx, ny, nz = model.nx, model.ny, model.nz
    count = torch.zeros(model.grid_shape, dtype=torch.int32, device=model.device)
    for di, dj, dk in ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                       (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)):
        count[di:di + nx, dj:dj + ny, dk:dk + nz] += 1
    pairs = int(count[~model.bc_mask.all(dim=0)].sum())
    nbytes = G3_BYTES_PER_NODE[dtype] * X * Y * Z + 8 * nx * ny * nz
    return bound(nbytes, G3_FLOPS_PER_PAIR * pairs,
                 F64_MATRIX_TFLOPS if dtype == torch.float64 else F32_TFLOPS)


def g3_kernel_phase(device, ss, mf):
    """Phase 29, the kernel: G3's ptxas lines; G3 against its plain version
    on ``G3_SHAPES`` and at 255^3 in f32 (1e-5 of max|ref|) and f64
    (1e-12), constrained outputs equal to x; at 255^3 its time beside its
    bound, the plain version's and the torch-composition yardstick's
    (which it must beat); G3 against K1 on the uniform 255^3 grid marked
    heterogeneous (3e-6 of max|K1 x|).  Returns the errors, the times and
    the 255^3 model and force."""
    from civiwave_tpu_torch.mesh.structured import build_structured_model
    from civiwave_tpu_torch.ops import structured as ops
    from civiwave_tpu_torch.ops.cuda import _build
    from civiwave_tpu_torch.ops.cuda import corner_gather as g3
    from civiwave_tpu_torch.ops.cuda import structured_stencil as k12
    from civiwave_tpu_torch.physics import materials
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    ptxas = ptxas_report(_build.load_library().log, ["corner_gather_kernel"])
    for line in ptxas:
        print(f"  G3 ptxas: {line}", flush=True)
    # registers and spill-store bytes of each instance (f: float, d: double)
    regs = {}
    for line in ptxas:
        if "Compiling entry" in line:
            key = "f32" if "corner_gather_kernelIf" in line else "f64"
        elif "spill stores" in line:
            regs.setdefault(key, {})["spill_stores"] = int(
                line.split("bytes spill stores")[0].split(",")[-1])
        elif "registers" in line:
            regs.setdefault(key, {})["registers"] = int(
                line.split("Used ")[1].split(" registers")[0])
    if sorted(regs) != ["f32", "f64"] or any(len(v) != 2 for v in regs.values()):
        fail(f"G3: registers and spills of both instances not in ptxas's "
             f"lines: {ptxas}")
    rng = np.random.default_rng(SEED)
    dtypes = ((torch.float32, "f32", OP_TOL), (torch.float64, "f64", F64_TOL))
    errs = {}

    # the small grids that cut the tiles and chunks
    for name, (dims, options) in G3_SHAPES.items():
        model, _ = hetero_model(dims, device, **options)
        line = []
        for dtype, key, tol in dtypes:
            x = torch.as_tensor(rng.standard_normal(model.vector_shape),
                                device=device).to(dtype)
            got = g3.apply_keff_corner_gather(model, x, ss, mf)
            ref = ops.apply_keff_structured_plain(model, x, ss, mf)
            torch.cuda.synchronize()
            err = check_close(f"G3 {key} {name}", got, ref, tol)
            if not torch.equal(got[model.bc_mask], x[model.bc_mask]):
                fail(f"G3 {key} {name}: constrained outputs differ from x")
            errs[f"odd_{key}"] = max(errs.get(f"odd_{key}", err), err,
                                     key=lambda e: e[1])
            line.append(f"{key} {err[1]:.3e}")
        print(f"G3 vs plain {name} {model.grid_shape}: " + ", ".join(line)
              + " of max|ref|; constrained outputs = x", flush=True)

    t0 = time.perf_counter()
    model, force = hetero_model(FULL, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"heterogeneous 255^3: {model.dof_count:,} DOF, lam/mu per cell, "
          f"model build {build_s:.3f} s (cell grids from the host)", flush=True)

    # G3 against its plain version at 255^3, f32 and f64
    bc = model.bc_mask
    times = {}
    for dtype, key, tol in dtypes:
        x = torch.as_tensor(rng.standard_normal(model.vector_shape),
                            device=device).to(dtype)
        got = g3.apply_keff_corner_gather(model, x, ss, mf)
        ref = ops.apply_keff_structured_plain(model, x, ss, mf)
        torch.cuda.synchronize()
        errs[key] = check_close(f"G3 {key} 255^3", got, ref, tol)
        if not torch.equal(got[bc], x[bc]):
            fail(f"G3 {key} 255^3: constrained outputs differ from x")
        composed = g3_composition(model, x, ss, mf)
        torch.cuda.synchronize()
        errs[f"composition_{key}"] = check_close(
            f"G3 composition {key} 255^3", composed, ref, tol)
        del got, ref, composed
        torch.cuda.empty_cache()
        least, by = g3_least(model, dtype)
        times[key] = dict(
            ms=time_ms(lambda: g3.apply_keff_corner_gather(model, x, ss, mf), 20),
            plain_ms=time_ms(
                lambda: ops.apply_keff_structured_plain(model, x, ss, mf), 2),
            bound_ms=least, bound_by=by, library_ms=None,
            torch_composition_ms=time_ms(
                lambda: g3_composition(model, x, ss, mf), 3),
            max_rel_err_odd_shapes=errs[f"odd_{key}"][1], **regs[key])
        t = times[key]
        print(f"G3 {key} 255^3: vs plain {errs[key][0]:.3e} abs, "
              f"{errs[key][1]:.3e} of max|ref| (tol {tol:g}); kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch "
              f"composition {t['torch_composition_ms']:.4f} ms (matmul "
              f"{errs[f'composition_{key}'][1]:.3e} of max|ref|), bound "
              f"{least:.4f} ms ({by}; {least / t['ms']:.3f} of it); "
              f"{t['registers']} registers, {t['spill_stores']} B spill "
              f"stores", flush=True)
        if t["ms"] >= t["torch_composition_ms"]:
            fail(f"G3 {key} 255^3: {t['ms']:.4f} ms, not faster than its "
                 f"torch composition ({t['torch_composition_ms']:.4f} ms)")
        del x
        torch.cuda.empty_cache()

    # G3 against K1 on the uniform 255^3 grid marked heterogeneous
    cfg = cantilever_config()
    uniform, _ = build_structured_model(
        *FULL, materials.make_properties(cfg.materials[0]),
        cfg.materials[0].density, device=device)
    x = torch.as_tensor(rng.standard_normal(uniform.vector_shape, dtype=np.float32),
                        device=device)
    k1 = k12.apply_keff_fused(uniform, x, ss, mf)
    got = g3.apply_keff_corner_gather(
        dataclasses.replace(uniform, homogeneous=False), x, ss, mf)
    torch.cuda.synchronize()
    errs["vs_k1"] = check_close("G3 vs K1 uniform 255^3", got, k1, 3e-6)
    print(f"G3 vs K1 on the uniform 255^3 grid: {errs['vs_k1'][1]:.3e} of "
          f"max|K1 x| (tol 3e-6)", flush=True)
    del uniform, x, k1, got
    torch.cuda.empty_cache()
    return errs, times, model, force


def heterogeneous_phase(device, ss, mf):
    """Phase 29: heterogeneous grids (per-cell lam/mu) through G3."""
    import contextlib
    import io

    from civiwave_tpu_torch.ops import multigrid
    from civiwave_tpu_torch.ops import structured as ops
    from civiwave_tpu_torch.solver.static import (
        solve_static,
        true_relative_residual,
    )

    errs, times, model, force = g3_kernel_phase(device, ss, mf)
    rng = np.random.default_rng(SEED + 1)

    # a multigrid request falls back to block-Jacobi with the note
    note = io.StringIO()
    with contextlib.redirect_stderr(note):
        requested = multigrid.attach_multigrid(model)
    text = note.getvalue().strip()
    if requested is not model or "heterogeneous material grid" not in text:
        fail(f"multigrid on a heterogeneous grid: model replaced or note "
             f"missing ({text!r})")
    print(f"multigrid request on the heterogeneous grid: {text}", flush=True)

    # the main path: 8 'auto' (= classic) frames at 255^3
    stepper = hetero_stepper(requested, force)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_f64_counts()
    reset_g3_counts()
    frame_s, tel = [], []
    for _ in range(HETERO_FRAMES):
        t0 = time.perf_counter()
        tel.append(stepper.step(stepper.accumulated_time))
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        if len(tel) == 3:
            u3 = (stepper.state.displacement.cpu(),
                  stepper.state.acceleration.cpu())
    counts = hetero_path_counts()
    peak = torch.cuda.max_memory_allocated()
    iters = [t.pcg_iterations for t in tel]
    if not all(t.pcg_converged for t in tel):
        fail(f"heterogeneous 255^3: not every frame converged: {iters}")
    if any(abs(a - b) > 1 for a, b in zip(iters, HETERO_ITERS)):
        fail(f"heterogeneous 255^3: iterations {iters}, not within 1 of "
             f"{list(HETERO_ITERS)}")
    state = stepper.state
    for name in ("displacement", "velocity", "acceleration"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            fail(f"heterogeneous 255^3: non-finite {name}")
    tip = float(state.displacement[2, FULL[0]].min())
    if not tip < 0.0:
        fail(f"heterogeneous 255^3: the loaded face did not deflect ({tip})")
    check_hetero_counts("heterogeneous 255^3", counts, "g3")
    # classic PCG: one matvec per iteration, plus the initial residual's
    # and the Rayleigh term's per frame
    if counts["g3"] != sum(iters) + 2 * HETERO_FRAMES:
        fail(f"heterogeneous 255^3: {counts['g3']} G3 launches for "
             f"{sum(iters)} iterations over {HETERO_FRAMES} frames")
    variant = stepper.pcg_variant()
    if variant != "classic" or not isinstance(stepper._precond, torch.Tensor):
        fail(f"heterogeneous 255^3: 'auto' is {variant}, pc "
             f"{type(stepper._precond).__name__}")
    steady = frame_s[1:]
    out = dict(iters=iters, counts=counts, steps_per_s=len(steady) / sum(steady),
               ms_per_iter=sum(steady) / sum(iters[1:]) * 1e3, peak=peak)
    pc = stepper._precond
    r = torch.as_tensor(rng.standard_normal(model.vector_shape, dtype=np.float32),
                        device=device)
    out["pc_apply_ms"] = time_ms(
        lambda: ops.apply_preconditioner_structured(model, pc, r), 20)
    # the stepper's dt is the 1 ms that ss and mf come from
    out["pc_build_ms"] = time_ms(lambda: model.build_preconditioner(ss, mf), 2)
    del r
    print(f"heterogeneous 255^3: 'auto' = {variant}, per-node block-Jacobi; "
          f"pcg iterations per frame {iters} (mean {np.mean(iters):.2f})",
          flush=True)
    print("heterogeneous 255^3: frame seconds " + ", ".join(
        f"{t:.4f}" for t in frame_s), flush=True)
    print(f"heterogeneous 255^3: steps/s {out['steps_per_s']:.4f} (frames 2-8), "
          f"{out['ms_per_iter']:.4f} ms per iteration (host clock); per-node "
          f"pc apply {out['pc_apply_ms']:.4f} ms, pc build "
          f"{out['pc_build_ms']:.4f} ms; peak device memory "
          f"{peak / 2**30:.3f} GiB ({peak} bytes)", flush=True)
    print(f"heterogeneous 255^3: kernel launches {counts} (G3 "
          f"{counts['g3'] / sum(iters):.3f} per iteration); tip u_z "
          f"{tip:.6e} m", flush=True)
    profile_window("heterogeneous 255^3 frame 9",
                   lambda: stepper.step(stepper.accumulated_time))
    del stepper, state, pc
    torch.cuda.empty_cache()

    # its static solve through solve_static (classic, per-node inverse)
    reset_g3_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, st = solve_static(model, force, tolerance=HETERO_STATIC_TOL,
                         max_iterations=STATIC_MAX_ITERS)
    torch.cuda.synchronize()
    static_s = time.perf_counter() - t0
    if not st.converged or not bool(torch.isfinite(u).all()):
        fail(f"heterogeneous static 255^3: converged {st.converged} after "
             f"{st.iterations} iterations")
    static_tip = float(u[2, FULL[0]].min())
    if not static_tip < 0.0:
        fail(f"heterogeneous static 255^3: the loaded face did not deflect "
             f"({static_tip})")
    # printed, not held: an f32 solution's true residual sits far above the
    # recurred one on a large grid (phase 16)
    residual = true_relative_residual(model, force, u)
    out["static"] = dict(iterations=st.iterations, seconds=static_s,
                         residual=residual, g3=g3_counts()["g3"], u=u.cpu())
    print(f"heterogeneous static 255^3 (tol {HETERO_STATIC_TOL:g}): "
          f"{st.iterations} iterations, {static_s:.4f} s, "
          f"{static_s / max(st.iterations, 1) * 1e3:.4f} ms per iteration, "
          f"true f64 relative residual {residual:.3e}, G3 {g3_counts()['g3']} "
          f"launches; tip u_z {static_tip:.6e} m", flush=True)
    del u

    # fp64: 3 frames through G3's f64 instance, against the f32 frames
    reset_f64_counts()
    reset_g3_counts()
    stepper = hetero_stepper(model, force, "fp64")
    t0 = time.perf_counter()
    tel64 = [stepper.step(stepper.accumulated_time) for _ in range(3)]
    torch.cuda.synchronize()
    fp64_s = time.perf_counter() - t0
    counts64 = hetero_path_counts()
    check_hetero_counts("heterogeneous fp64 255^3", counts64, "g3_f64")
    iters64 = [t.pcg_iterations for t in tel64]
    if not all(t.pcg_converged for t in tel64) or any(
            abs(a - b) > 1 for a, b in zip(iters64, iters)):
        fail(f"heterogeneous fp64 255^3: iterations {iters64} (f32 "
             f"{iters[:3]}), converged {[t.pcg_converged for t in tel64]}")
    state = stepper.state
    if state.displacement.dtype != torch.float64:
        fail("heterogeneous fp64 255^3: the state is not f64")
    fp64_errs = [check_close(f"heterogeneous fp64 vs f32 {name}",
                             getattr(state, name).float().cpu(), ref, tol)[1]
                 for name, ref, tol in (("displacement", u3[0], U_TOL),
                                        ("acceleration", u3[1], A_TOL))]
    out["fp64"] = dict(iters=iters64, counts=counts64, seconds=fp64_s,
                       u=state.displacement.cpu(), a=state.acceleration.cpu())
    print(f"heterogeneous fp64 255^3: 3 frames, iterations {iters64} (f32 "
          f"{iters[:3]}), {fp64_s:.4f} s, G3 f64 {counts64['g3_f64']} "
          f"launches; against the f32 frames u {fp64_errs[0]:.3e}, a "
          f"{fp64_errs[1]:.3e} of max", flush=True)
    del stepper, state, model, force
    torch.cuda.empty_cache()

    # a small heterogeneous box on the card and on the CPU
    cells = hetero_cells(HETERO_BOX)
    runs = []
    for dev in (device, torch.device("cpu")):
        box, box_force = hetero_model(HETERO_BOX, dev, cells)
        box_stepper = hetero_stepper(box, box_force)
        runs.append(([box_stepper.step(box_stepper.accumulated_time)
                      for _ in range(10)], box_stepper.state))
    (tg, sg), (tc, sc) = runs
    it_g = [t.pcg_iterations for t in tg]
    it_c = [t.pcg_iterations for t in tc]
    if any(abs(a - b) > 1 for a, b in zip(it_g, it_c)) or not all(
            t.pcg_converged for t in tg):
        fail(f"heterogeneous box: iterations gpu {it_g} cpu {it_c}")
    box_errs = [check_close(f"heterogeneous box {name}",
                            getattr(sg, name).cpu(), getattr(sc, name), tol)[1]
                for name, tol in (("displacement", U_TOL),
                                  ("acceleration", A_TOL))]
    print(f"heterogeneous box {HETERO_BOX} 10 frames GPU vs CPU: iterations "
          f"gpu {it_g} cpu {it_c}; u {box_errs[0]:.3e}, a {box_errs[1]:.3e} "
          f"of max", flush=True)
    return errs, times, out



# --- heterogeneous grids on a shard (A11 part 2): G3 over a plane range ----

# phase 30's in-process cuts of the 255^3 heterogeneous grid: (label,
# (npx, npy), 2-D); the 4 slabs have K5's 64-plane slab shape (phase 14)
HETERO_CUTS = [("4 slabs (Xl 64)", (4, 1), False),
               ("2x2 tiles (128x128)", (2, 2), True)]


def g3_shard_least(local, dtype):
    """(least ms, bound_by) of one G3 call on a shard: G3's bytes per node
    on the block's nodes, lam and mu of each live cell of the block and of
    its ghost cells once, each ghost node's values and mask once; the
    operations of the block's (node, live cell) pairs."""
    X, Y, Z = local.grid_shape
    nz = local.nz
    gx = torch.arange(-1, X, device=local.device) + local.x0
    gy = torch.arange(-1, Y, device=local.device) + local.y0
    live = (((gx >= 0) & (gx < local.nx))[:, None]
            & ((gy >= 0) & (gy < local.ny))[None, :]).to(torch.int32)
    count = torch.zeros(local.grid_shape, dtype=torch.int32, device=local.device)
    for di, dj, dk in ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                       (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)):
        count[:, :, dk:dk + nz] += live[1 - di:1 - di + X, 1 - dj:1 - dj + Y, None]
    pairs = int(count[~local.bc_mask.all(dim=0)].sum())
    two_d = local.bc_ghosts.y_lo is not None
    ghost_nodes = 2 * (Y + 2 * int(two_d)) * Z + (2 * X * Z if two_d else 0)
    elem = 8 if dtype == torch.float64 else 4
    nbytes = (G3_BYTES_PER_NODE[dtype] * X * Y * Z + 8 * nz * int(live.sum())
              + (3 * elem + 3) * ghost_nodes)
    return bound(nbytes, G3_FLOPS_PER_PAIR * pairs,
                 F64_MATRIX_TFLOPS if dtype == torch.float64 else F32_TFLOPS)


def hetero_shard_kernel_phase(device, ss, mf, k5_slab_ms):
    """Phase 30, in this process: phase 29's 255^3 heterogeneous grid cut
    into 4 slabs and 2x2 tiles (``HETERO_CUTS``), each shard's G3 with and
    without the overlap split in f32 and f64, every cut gathered against
    the whole-grid G3 bit for bit, each shard against G3's plain shard
    version (1e-5 / 1e-12 of max); G3 on an inner 64-plane slab timed
    beside its bound and K5's time on that slab shape (phase 14)."""
    from civiwave_tpu_torch.ops.cuda import corner_gather as g3

    model, _ = hetero_model(FULL, device)
    rng = np.random.default_rng(SEED + 30)
    errs, times = {}, {}
    for dtype, key, tol in ((torch.float32, "f32", OP_TOL),
                            (torch.float64, "f64", F64_TOL)):
        s_, m_ = (ss, mf) if dtype == torch.float32 else (float(ss), float(mf))
        x = torch.as_tensor(rng.standard_normal(model.vector_shape),
                            device=device).to(dtype)
        whole = g3.apply_keff_corner_gather(model, x, s_, m_)
        worst = (0.0, 0.0)
        for label, shape, two_d in HETERO_CUTS:
            gathered = torch.full_like(x, float("nan"))
            tiles = halo_tiles(model, x, shape, two_d)
            for local, xt, ghosts, (x0, y0, xl, yl) in tiles:
                out = g3.apply_keff_corner_gather(local, xt, s_, m_, ghosts)
                if not torch.equal(split_keff(local, xt, ghosts, s_, m_), out):
                    fail(f"G3 {key} {label} ({x0}, {y0}): the overlap split "
                         f"differs from one launch")
                plain = g3.apply_keff_corner_gather_plain_shard(
                    local, xt, s_, m_, ghosts)
                worst = max(worst, check_close(
                    f"G3 {key} {label} ({x0}, {y0}) vs plain", out, plain, tol),
                    key=lambda e: e[1])
                del plain
                gathered[:, x0:x0 + xl, y0:y0 + yl] = out
            if not torch.equal(gathered, whole):
                fail(f"G3 {key} {label}: the gathered shards differ from the "
                     f"whole-grid G3 ({int((gathered != whole).sum()):,} values)")
            print(f"G3 {key} 255^3 {label}: {len(tiles)} shards, with and "
                  f"without the split, gathered bit-equal to the whole-grid "
                  f"G3; vs plain shard max rel err {worst[1]:.3e} (tol {tol:g})",
                  flush=True)
            if label.startswith("4 slabs"):
                local, xt, ghosts, _ = tiles[1]  # an inner slab
                least, by = g3_shard_least(local, dtype)
                t = dict(
                    ms=time_ms(lambda: g3.apply_keff_corner_gather(
                        local, xt, s_, m_, ghosts), 20),
                    plain_ms=time_ms(lambda: g3.apply_keff_corner_gather_plain_shard(
                        local, xt, s_, m_, ghosts), 3),
                    bound_ms=least, bound_by=by, library_ms=None,
                    split_ms=time_ms(lambda: split_keff(local, xt, ghosts, s_, m_), 20),
                    k5_slab64_ms=k5_slab_ms)
                times[key] = t
                print(f"time G3 {key} slab64 {tuple(local.grid_shape)}: kernel "
                      f"{t['ms']:.4f} ms (overlap split, 3 launches, "
                      f"{t['split_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms; "
                      f"bound {least:.4f} ms by {by} ({least / t['ms']:.3f} of it); "
                      f"K5 on the same slab shape (phase 14) {k5_slab_ms:.4f} ms",
                      flush=True)
            del gathered, tiles
            torch.cuda.empty_cache()
        errs[key] = worst
        del x, whole
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return errs, times


def hetero_frames(stepper, n, label):
    """``n`` frames of ``stepper``, each synchronised: iterations, frame
    seconds, peak device memory, steps/s and ms per iteration over frames
    2 on, and the final u and a."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frame_s, tel = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        tel.append(stepper.step(stepper.accumulated_time))
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    iters = [t.pcg_iterations for t in tel]
    if not all(t.pcg_converged for t in tel):
        fail(f"{label}: not every frame converged: {iters}")
    steady = frame_s[1:]
    return dict(iters=iters, frame_s=frame_s,
                peak=torch.cuda.max_memory_allocated(),
                steps_per_s=len(steady) / sum(steady),
                ms_per_iter=sum(steady) / sum(iters[1:]) * 1e3,
                u=stepper.state.displacement, a=stepper.state.acceleration)


def hetero_shard_phase(device, ss, mf, hetero, k5_slab_ms):
    """Phase 30: heterogeneous grids on a shard (G3 over a plane range with
    ghost planes, rows and cells; the per-node block-Jacobi of a shard)."""
    from civiwave_tpu_torch.parallel.sharding import (
        close_shard_group,
        make_shard_group,
        make_shard_group_2d,
        shard_structured,
    )

    errs, times = hetero_shard_kernel_phase(device, ss, mf, k5_slab_ms)
    model, force = hetero_model(FULL, device)

    # the unsharded fused loop on the same grid: what the shards are held to
    ref = hetero_stepper(model, force)
    ref.solver_variant = "fused"
    reset_g3_counts()
    fused = hetero_frames(ref, HETERO_FRAMES, "heterogeneous 255^3 fused")
    fused.update(g3=g3_counts()["g3"], u=fused["u"].cpu(), a=fused["a"].cpu())
    print(f"heterogeneous 255^3 unsharded fused: iterations {fused['iters']}, "
          f"steps/s {fused['steps_per_s']:.4f}, {fused['ms_per_iter']:.4f} ms per "
          f"iteration (phase 29 classic {hetero['steps_per_s']:.4f}, "
          f"{hetero['ms_per_iter']:.4f}); G3 {fused['g3']} launches", flush=True)
    del ref
    torch.cuda.empty_cache()

    out = {"fused": {k: v for k, v in fused.items() if k not in ("u", "a")}}
    for label, make, exchanges in (
        ("1-D", lambda: make_shard_group(1, device), 2),
        ("2-D", lambda: make_shard_group_2d(1, 1, device), 4),
    ):
        name = f"heterogeneous shard {label} 255^3"
        group = make()
        reset_sharded_counts()
        sm, _, sf = shard_structured(model, model.zero_state(), force, group)
        # the mask's ghosts (2 or 4 exchanges) and the ghost cells (1 or 2)
        shard_exchanges = sharded_counts()["ppermute"]
        if shard_exchanges != exchanges + exchanges // 2:
            fail(f"{name}: {shard_exchanges} exchanges at shard time")
        stepper = hetero_stepper(sm, sf)
        reset_sharded_counts()
        reset_g3_counts()
        reset_f64_counts()
        run = hetero_frames(stepper, HETERO_FRAMES, name)
        variant = stepper.pcg_variant()
        if variant != "fused" or not isinstance(stepper._precond, torch.Tensor):
            fail(f"{name}: 'auto' is {variant}, pc {type(stepper._precond).__name__}")
        kernels = hetero_path_counts()
        collectives_ = sharded_counts()
        iters = run["iters"]
        if any(abs(a - b) > 1 for a, b in zip(iters, fused["iters"])):
            fail(f"{name}: iterations {iters} not within 1 of the unsharded "
                 f"fused frames' {fused['iters']}")
        check_hetero_counts(name, kernels, "g3")
        matvecs = 3 * HETERO_FRAMES + sum(iters)
        want = {"g3": 3 * matvecs, "ppermute": exchanges * matvecs,
                "psum_f64_3": sum(iters), "psum_f64_4": HETERO_FRAMES}
        got = {"g3": kernels["g3"],
               **{k: collectives_[k] for k in ("ppermute", "psum_f64_3",
                                                "psum_f64_4")}}
        if got != want:
            fail(f"{name}: counts {got}, expected {want}")
        e = {}
        for field, tol in (("u", U_TOL), ("a", A_TOL)):
            v = run[field]
            if not bool(torch.isfinite(v).all()):
                fail(f"{name}: non-finite {field}")
            _, e[field] = check_close(f"{name} {field}", v.cpu(), fused[field], tol)
        print(f"{name}: 'auto' = fused, per-node block-Jacobi; iterations "
              f"{iters} (unsharded fused {fused['iters']}); max abs err / "
              f"max|unsharded| u {e['u']:.3e} (tol {U_TOL:g}), a {e['a']:.3e} "
              f"(tol {A_TOL:g}); counts {got} (G3 3 per matvec: the overlap "
              f"split), no other kernel; {shard_exchanges} exchanges at shard "
              f"time", flush=True)
        print(f"{name}: frame seconds " + ", ".join(
            f"{t:.4f}" for t in run["frame_s"]), flush=True)
        print(f"{name}: steps/s {run['steps_per_s']:.4f} (frames 2-8; unsharded "
              f"fused {fused['steps_per_s']:.4f}), {run['ms_per_iter']:.4f} ms per "
              f"iteration (unsharded fused {fused['ms_per_iter']:.4f}); peak device "
              f"memory {run['peak'] / 2**30:.3f} GiB ({run['peak']} bytes)",
              flush=True)
        profile_window(f"{name} frame 9",
                       lambda: stepper.step(stepper.accumulated_time))
        out[label] = dict(iters=iters, counts=got, err_u=e["u"], err_a=e["a"],
                          **{k: run[k] for k in ("steps_per_s", "ms_per_iter",
                                                 "peak")})
        del stepper, run
        torch.cuda.empty_cache()
        if label == "1-D":
            out.update(hetero_shard_fp64_static(name, sm, sf, group, hetero))
        del sm, sf
        close_shard_group()
        torch.cuda.empty_cache()
    del model, force
    torch.cuda.empty_cache()
    return errs, times, out


def hetero_shard_fp64_static(name, sm, sf, group, hetero):
    """Phase 30 on the one-rank 1-D shard: 3 fp64 frames (G3's f64 instance
    alone) against phase 29's fp64 frames, and the static solve (classic,
    phase 29's variant) to 1e-6 against phase 29's static u."""
    from civiwave_tpu_torch.parallel.sharding import gather_structured
    from civiwave_tpu_torch.solver.static import solve_static

    reset_sharded_counts()
    reset_g3_counts()
    reset_f64_counts()
    stepper = hetero_stepper(sm, sf, "fp64")
    run = hetero_frames(stepper, 3, f"{name} fp64")
    counts = hetero_path_counts()
    check_hetero_counts(f"{name} fp64", counts, "g3_f64")
    it64 = run["iters"]
    if any(abs(a - b) > 1 for a, b in zip(it64, hetero["fp64"]["iters"])):
        fail(f"{name} fp64: iterations {it64}, phase 29 {hetero['fp64']['iters']}")
    if counts["g3_f64"] != 3 * (9 + sum(it64)):
        fail(f"{name} fp64: {counts['g3_f64']} G3 f64 launches for "
             f"{sum(it64)} iterations")
    if run["u"].dtype != torch.float64:
        fail(f"{name} fp64: the state is not f64")
    e64 = [check_close(f"{name} fp64 {field}", run[field].float().cpu(),
                       hetero["fp64"][field].float(), tol)[1]
           for field, tol in (("u", U_TOL), ("a", A_TOL))]
    fp64 = dict(iters=it64, g3_f64=counts["g3_f64"],
                seconds=sum(run["frame_s"]), err_u=e64[0], err_a=e64[1])
    print(f"{name} fp64: 3 frames, iterations {it64} (phase 29 unsharded "
          f"classic {hetero['fp64']['iters']}), {fp64['seconds']:.4f} s, G3 f64 "
          f"{counts['g3_f64']} launches; against phase 29's fp64 frames u "
          f"{e64[0]:.3e}, a {e64[1]:.3e} of max", flush=True)
    del stepper, run
    torch.cuda.empty_cache()

    reset_g3_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, st = solve_static(sm, sf, tolerance=HETERO_STATIC_TOL,
                         max_iterations=STATIC_MAX_ITERS, variant="classic")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not st.converged or not bool(torch.isfinite(u).all()):
        fail(f"{name} static: converged {st.converged} after {st.iterations} "
             f"iterations")
    _, err = check_close(f"{name} static u", gather_structured(u, group).cpu(),
                         hetero["static"]["u"], U_TOL)
    static = dict(iterations=st.iterations, seconds=seconds, err=err,
                  g3=g3_counts()["g3"])
    print(f"{name} static (classic, tol {HETERO_STATIC_TOL:g}): "
          f"{st.iterations} iterations in {seconds:.4f} s (phase 29 unsharded "
          f"{hetero['static']['iterations']} in {hetero['static']['seconds']:.4f} "
          f"s); u {err:.3e} of max|u| from phase 29's; G3 {static['g3']} "
          f"launches", flush=True)
    return {"fp64": fp64, "static": static}



# --- the port's remainder: a shard's checkpoints and output, the native
# Gmsh parser, the interactive session and its viewer (phases 31-33) --------

SHARD_OUTPUT_FRAMES = 8  # phase 17b's frames, with its VTU stride
HETERO_OUTPUT_FRAMES = 4
GENERAL_OUTPUT_FRAMES = 3


def output_counts():
    """The collectives' calls, the gathers of output and checkpoints
    included."""
    from civiwave_tpu_torch.parallel import collectives

    return {"ppermute": collectives.ppermute.calls,
            "gather": collectives.gather.calls}


def same_state(label, a, b):
    """Fail unless two SimStates are equal bit for bit."""
    for name in ("displacement", "velocity", "acceleration", "warm_x"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            fail(f"{label}: {name} differs")


def dir_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def compare_output_dirs(label, got, ref):
    """The files of two output directories of separate runs: the same
    names, VTU arrays (u at U_TOL, the rest at A_TOL) and probe rows at the
    stepping tolerances; returns (whether every file is byte-identical,
    the worst error of max|ref|)."""
    import filecmp

    files = dir_files(got)
    if files != dir_files(ref):
        fail(f"{label}: files {files}, the unsharded run's {dir_files(ref)}")
    identical = all(filecmp.cmp(os.path.join(got, f), os.path.join(ref, f),
                                shallow=False) for f in files)
    worst = 0.0
    for f in files:
        if f.endswith(".vtu"):
            a = read_vtu(os.path.join(got, f))[1]
            b = read_vtu(os.path.join(ref, f))[1]
            if sorted(a) != sorted(b):
                fail(f"{label} {f}: arrays {sorted(a)} vs {sorted(b)}")
            for name in a:
                tol = U_TOL if name == "displacement" else A_TOL
                worst = max(worst, check_rows(f"{label} {f} {name}", a[name],
                                              b[name], tol))
        elif f.endswith(".csv"):
            worst = max(worst, check_probe_tables(
                label, probe_table(os.path.join(got, f)),
                probe_table(os.path.join(ref, f))))
    return identical, worst


def unsharded_view(shard):
    """A one-rank shard's model without its group: the block is the whole
    grid, so this is the unsharded model over the same tensors."""
    return dataclasses.replace(shard, shard_group=None, local_extent=None,
                               bc_ghosts=None, cell_ghosts=None)


def check_shard_fields(label, sim, device):
    """On a one-rank shard's last state: its derived fields (gathered) and
    probe rows against the unsharded functions on the same state, bit for
    bit; the derived fields' device ms and the probe rows' ms per frame."""
    from civiwave_tpu_torch.post import structured_fields as fields

    model, state = sim.model, sim.stepper.state
    plain = unsharded_view(model)
    got = fields.gather_derived(model, fields.compute_structured_derived(
        model, state.displacement))
    want = fields.compute_structured_derived(plain, state.displacement)
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            fail(f"{label}: derived field {i} differs from the unsharded "
                 f"function's on the same u by "
                 f"{float((g - w).abs().max()):.3e}")
    del got, want
    probes = sim.config.output.probes
    kin, rows = fields.probe_rows(model, state, probes)
    kin0, rows0 = fields.probe_rows(plain, state, probes)
    if not np.array_equal(kin, kin0) or any(
            not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                 and a[2] == b[2]) for a, b in zip(rows, rows0)):
        fail(f"{label}: probe rows differ from the unsharded ones")
    derived_ms = time_ms(lambda: fields.compute_structured_derived(
        model, state.displacement), 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        fields.probe_rows(model, state, probes)
    probe_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.empty_cache()
    return derived_ms, probe_ms


def shard_output_frames(sim, frames, manager, every):
    """``frames`` frames of ``sim`` one ``run`` call each (the writer's
    flush deferred, as phase 17b), saving checkpoints in ``manager`` every
    ``every`` frames: (telemetries, frame seconds, flush seconds, VTU write
    seconds)."""
    write_s, flush = defer_output(sim.output)
    torch.cuda.synchronize()
    frame_s, tel = [], []
    for _ in range(frames):
        t0 = time.perf_counter()
        tel += sim.run(1, checkpoint_manager=manager, checkpoint_every=every)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    flush()
    manager.wait()
    return tel, frame_s, time.perf_counter() - t0, write_s


def checkpoint_round_trip(label, sim, fresh, manager, step, frames):
    """A new shard ``fresh`` restores ``manager``'s checkpoint ``step``
    (timed) and runs ``frames`` frames: its state must equal ``sim``'s
    bit for bit.  Also times the save of ``sim``'s end state.  Returns
    (bytes, save s, restore s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.stepper.save_checkpoint(manager, wait=True)
    save_s = time.perf_counter() - t0
    path = manager.path(sim.stepper.frame_index)
    nbytes = os.path.getsize(path)
    t0 = time.perf_counter()
    if fresh.stepper.restore_checkpoint(manager, step) != step:
        fail(f"{label}: restored another frame than {step}")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    fresh.run(frames)
    same_state(f"{label}: resumed from frame {step}", fresh.stepper.state,
               sim.stepper.state)
    return nbytes, save_s, restore_s


def shard_output_group(device, label, make_group, phase17):
    """Phase 31a-b: phase 17b's scenario (255^3, probes, a VTU every 8
    frames) through ``shard_simulation`` over a one-rank group, 8 frames
    with a checkpoint every 4: iterations within 1 of phase 17b's, the
    output directory against phase 17b's, the checkpoint of frame 4
    resumed bit-equal, the derived fields and probes bit-equal to the
    unsharded functions', the collectives the output made."""
    import shutil

    from civiwave_tpu_torch.parallel.sharding import shard_simulation
    from civiwave_tpu_torch.runner import build_simulation
    from civiwave_tpu_torch.utils.checkpoint import CheckpointManager

    name = f"shard output {label} 255^3"
    cfg = output_255_config()
    tmp = scratch_dir(f"shard_output_{label}")
    try:
        group = make_group()
        two_d = group.two_d
        sim = shard_simulation(build_simulation(
            cfg, device=device, output_root=os.path.join(tmp, "out")), group)
        manager = CheckpointManager(os.path.join(tmp, "ck"))
        torch.cuda.reset_peak_memory_stats()
        reset_sharded_counts()
        tel, frame_s, flush_s, write_s = shard_output_frames(
            sim, SHARD_OUTPUT_FRAMES, manager, 4)
        counts = {**sharded_counts(), **output_counts()}
        peak = torch.cuda.max_memory_allocated()
        iters = [t.pcg_iterations for t in tel]
        if not all(t.pcg_converged for t in tel) or any(
                abs(a - b) > 1 for a, b in zip(iters, phase17["iters"])):
            fail(f"{name}: iterations {iters} against phase 17b's "
                 f"{phase17['iters']}")
        # the solver's collectives (phase 15's budget), then the output's:
        # one VTU frame (u's ghosts once, 6 derived fields and u, v, a
        # gathered), a probe gather per frame, 4 gathers per checkpoint
        exchanges = 4 if two_d else 2
        matvecs = 3 * len(iters) + sum(iters)
        want = {"ppermute": exchanges * (matvecs + 1),
                "gather": 9 + SHARD_OUTPUT_FRAMES + 4}
        if {k: counts[k] for k in want} != want:
            fail(f"{name}: collectives {counts}, expected {want}")
        identical, worst = compare_output_dirs(
            name, os.path.join(tmp, "out"), phase17["root"])
        shutil.rmtree(os.path.join(tmp, "out"), ignore_errors=True)
        fresh = shard_simulation(build_simulation(cfg, device=device),
                                 make_group())
        nbytes, save_s, restore_s = checkpoint_round_trip(
            name, sim, fresh, manager, 5, SHARD_OUTPUT_FRAMES - 5)
        del fresh
        torch.cuda.empty_cache()
        derived_ms, probe_ms = check_shard_fields(name, sim, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steady = frame_s[1:]
    # frame 5 (index 4) saves frame 4's checkpoint
    no_ckpt = frame_s[1:4] + frame_s[5:]
    out = dict(iters=iters, counts=counts, steps_per_s=len(steady) / sum(steady),
               steps_no_ckpt=len(no_ckpt) / sum(no_ckpt),
               steps_all=len(frame_s) / (sum(frame_s) + flush_s),
               ms_per_iter=sum(steady) / sum(iters[1:]) * 1e3, peak=peak,
               vtu_write_s=write_s[0], derived_ms=derived_ms, probe_ms=probe_ms,
               ckpt_bytes=nbytes, save_s=save_s, restore_s=restore_s,
               identical=identical, worst=worst)
    print(f"{name}: iterations {iters} (phase 17b {phase17['iters']}); frame "
          f"seconds " + ", ".join(f"{t:.4f}" for t in frame_s) + f", then "
          f"{flush_s:.4f} s waiting for the writer; steps/s {out['steps_per_s']:.4f} "
          f"over frames 2-8 while frame 0's VTU is written (phase 17b "
          f"{phase17['steps_per_s']:.4f}), {out['steps_no_ckpt']:.4f} without frame "
          f"5 (it saves a checkpoint), {out['steps_all']:.4f} over all 8 with "
          f"the wait; {out['ms_per_iter']:.4f} ms per iteration; peak device "
          f"memory {peak / 2**30:.3f} GiB", flush=True)
    print(f"{name}: output directory against phase 17b's: the same files, "
          f"byte-identical {identical}, worst {worst:.3e} of max|.|; VTU frame 0 "
          f"written in {write_s[0]:.3f} s; derived fields {derived_ms:.4f} ms "
          f"device time, bit-equal to the unsharded function's; probes "
          f"{probe_ms:.4f} ms per frame, bit-equal; collectives per frame: "
          f"{exchanges} ppermute + {9 + 1} gathers on a VTU frame, 1 gather on "
          f"the others, 4 gathers per checkpoint (counts {counts})", flush=True)
    print(f"{name}: checkpoint {nbytes:,} bytes, save {save_s:.3f} s, restore "
          f"{restore_s:.3f} s; frame 4's checkpoint resumed to frame 8 bit-equal",
          flush=True)
    return out


def hetero_output_group(device):
    """Phase 31c: the heterogeneous 255^3 cantilever (phase 29's grid)
    through ``shard_simulation`` over a one-rank 1-D group (G3 per shard),
    4 frames with output (a VTU every 4) and a checkpoint every 2, frame
    2's checkpoint resumed bit-equal, the derived fields and probes
    bit-equal to the unsharded functions'."""
    import shutil

    from civiwave_tpu_torch.mesh.structured_config import (
        StructuredForceSchedule,
    )
    from civiwave_tpu_torch.parallel.sharding import (
        make_shard_group,
        shard_simulation,
    )
    from civiwave_tpu_torch.post.output import StructuredOutputManager
    from civiwave_tpu_torch.runner import Simulation
    from civiwave_tpu_torch.utils.checkpoint import CheckpointManager

    name = "shard output heterogeneous 1-D 255^3"
    cfg = output_255_config(vtu_stride=HETERO_OUTPUT_FRAMES)
    model, force = hetero_model(FULL, device)

    def simulation(root=None):
        stepper = hetero_stepper(model, force)
        output = (None if root is None
                  else StructuredOutputManager(root, cfg.output, model))
        sim = Simulation(config=cfg, model=model, stepper=stepper,
                         force_schedule=StructuredForceSchedule(force, []),
                         output=output)
        return shard_simulation(sim, make_shard_group(1, device))

    tmp = scratch_dir("shard_output_hetero")
    try:
        sim = simulation(os.path.join(tmp, "out"))
        manager = CheckpointManager(os.path.join(tmp, "ck"))
        reset_g3_counts()
        tel, frame_s, flush_s, write_s = shard_output_frames(
            sim, HETERO_OUTPUT_FRAMES, manager, 2)
        g3 = g3_counts()["g3"]
        iters = [t.pcg_iterations for t in tel]
        if not all(t.pcg_converged for t in tel) or any(
                abs(a - b) > 1 for a, b in zip(iters, HETERO_ITERS)):
            fail(f"{name}: iterations {iters} against {HETERO_ITERS[:4]}")
        files = dir_files(os.path.join(tmp, "out"))
        if files != ["probes/probes.csv", "vtu/frame_00000.vtu"]:
            fail(f"{name}: files {files}")
        if g3 != 3 * (3 * len(iters) + sum(iters)):
            fail(f"{name}: {g3} G3 launches for iterations {iters}")
        fresh = simulation()
        nbytes, save_s, restore_s = checkpoint_round_trip(
            name, sim, fresh, manager, 3, HETERO_OUTPUT_FRAMES - 3)
        del fresh
        derived_ms, probe_ms = check_shard_fields(name, sim, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steady = frame_s[1:]
    out = dict(iters=iters, g3=g3, steps_per_s=len(steady) / sum(steady),
               vtu_write_s=write_s[0], derived_ms=derived_ms,
               probe_ms=probe_ms, ckpt_bytes=nbytes, save_s=save_s,
               restore_s=restore_s)
    print(f"{name}: iterations {iters}; G3 {g3} launches (3 per matvec); frame "
          f"seconds " + ", ".join(f"{t:.4f}" for t in frame_s) + f", then "
          f"{flush_s:.4f} s for the writer; steps/s {out['steps_per_s']:.4f} over "
          f"frames 2-4; VTU frame 0 written in {write_s[0]:.3f} s; derived "
          f"fields {derived_ms:.4f} ms, probes {probe_ms:.4f} ms per frame, both "
          f"bit-equal to the unsharded functions'; checkpoint {nbytes:,} bytes, "
          f"save {save_s:.3f} s, restore {restore_s:.3f} s, frame 2's resumed "
          f"bit-equal", flush=True)
    del sim, model, force
    torch.cuda.empty_cache()
    return out


def general_output_group(device):
    """Phase 31d: phase 8's 66^3 tet cantilever through ``shard_simulation``
    over a one-rank group (K7 + G1), 3 frames with output (a VTU every 2,
    probes; derived fields on rank 0's host) and a checkpoint every frame:
    the VTU's displacement is the gathered state's, frame 1's checkpoint
    resumed bit-equal, 3 gathers per frame."""
    import shutil

    from civiwave_tpu_torch.parallel.sharding import (
        make_shard_group,
        shard_simulation,
    )
    from civiwave_tpu_torch.runner import build_simulation
    from civiwave_tpu_torch.utils.checkpoint import CheckpointManager
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    n = GENERAL_N
    name = f"shard output general one rank tet {n}^3"
    cfg = cantilever_config(
        mesh={"path": f"synthetic://box/{n},{n},{n},tet"}, dt=1e-3,
        adaptive=False, tol_runtime=2e-4, max_iters=300,
        output={"vtu_stride": 2, "probes": [0, (n + 1) ** 3 // 2,
                                            (n + 1) ** 3 - 1]})
    tmp = scratch_dir("shard_output_general")
    try:
        sim = shard_simulation(build_simulation(
            cfg, device=device, output_root=os.path.join(tmp, "out")),
            make_shard_group(1, device))
        manager = CheckpointManager(os.path.join(tmp, "ck"))
        reset_general_shard_counts()
        write_s, flush = defer_output(sim.output)
        frame_s, tel = [], []
        for frame in range(GENERAL_OUTPUT_FRAMES):
            t0 = time.perf_counter()
            tel += sim.run(1, checkpoint_manager=manager, checkpoint_every=1)
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
            if frame == 2:
                u2 = sim.stepper.displacement()
        flush()
        manager.wait()
        counts = {**general_shard_counts(), **output_counts()}
        iters = [t.pcg_iterations for t in tel]
        if not all(t.pcg_converged for t in tel):
            fail(f"{name}: not every frame converged: {iters}")
        files = dir_files(os.path.join(tmp, "out"))
        if files != ["probes/probes.csv", "vtu/frame_00000.vtu",
                     "vtu/frame_00002.vtu"]:
            fail(f"{name}: files {files}")
        vtu_u = read_vtu(os.path.join(tmp, "out", "vtu", "frame_00002.vtu"),
                         ["displacement"])[1]["displacement"]
        if not np.array_equal(vtu_u, u2.astype(np.float32).reshape(-1)):
            fail(f"{name}: the VTU's displacement is not the gathered state")
        matvecs = 2 * len(iters) + sum(iters)  # phase 25's classic frames
        want_gathers = 3 * GENERAL_OUTPUT_FRAMES + 4 * (GENERAL_OUTPUT_FRAMES - 1)
        if (counts["gather"] != want_gathers
                or counts["element_forces_tet"] != matvecs):
            fail(f"{name}: counts {counts}, expected {want_gathers} gathers "
                 f"and {matvecs} K7 launches")
        fresh = shard_simulation(build_simulation(cfg, device=device),
                                 make_shard_group(1, device))
        nbytes, save_s, restore_s = checkpoint_round_trip(
            name, sim, fresh, manager, 2, GENERAL_OUTPUT_FRAMES - 2)
        del fresh
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = dict(iters=iters, counts=counts, frame_s=frame_s,
               vtu_write_s=write_s, ckpt_bytes=nbytes, save_s=save_s,
               restore_s=restore_s)
    print(f"{name}: iterations {iters}; frame seconds (host derived fields and "
          f"probes every frame) " + ", ".join(f"{t:.4f}" for t in frame_s)
          + f"; VTU writes " + ", ".join(f"{t:.3f}" for t in write_s) + " s; "
          f"the VTU's u equals the gathered state; 3 gathers per frame, 4 per "
          f"checkpoint (counts {counts}); checkpoint {nbytes:,} bytes, save "
          f"{save_s:.3f} s, restore {restore_s:.3f} s, frame 1's resumed "
          f"bit-equal", flush=True)
    del sim
    torch.cuda.empty_cache()
    return out


def shard_output_phase(device, phase17):
    """Phase 31: checkpoints, output, derived fields and probes of a shard
    at full width (one-rank 1-D and 2-D groups, the heterogeneous 1-D
    group, the general 66^3 tet group); removes phase 17b's output."""
    import shutil

    from civiwave_tpu_torch.parallel.sharding import (
        close_shard_group,
        make_shard_group,
        make_shard_group_2d,
    )

    t0 = time.perf_counter()
    try:
        out = {
            "1-D": shard_output_group(device, "1-D",
                                      lambda: make_shard_group(1, device),
                                      phase17),
            "2-D": shard_output_group(device, "2-D",
                                      lambda: make_shard_group_2d(1, 1, device),
                                      phase17),
        }
    finally:
        shutil.rmtree(phase17["root"], ignore_errors=True)
    out["hetero"] = hetero_output_group(device)
    out["general"] = general_output_group(device)
    close_shard_group()
    print(f"phase 31: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def gmsh_text(mesh) -> str:
    """A mesh as Gmsh 4.1 ASCII text: one node block, surface blocks by
    physical group and type, one volume block (tests/test_native_gmsh.py's
    layout, written with numpy)."""
    def rows(a):
        return "\n".join(" ".join(r) for r in np.asarray(a).astype(str)) + "\n"

    n, e = mesh.node_count, mesh.element_count
    parts = ["$MeshFormat\n4.1 0 8\n$EndMeshFormat\n$PhysicalNames\n3\n"
             '2 1 "FIXED"\n2 2 "LOAD_FACE"\n3 3 "SOLID"\n$EndPhysicalNames\n',
             f"$Nodes\n1 {n} 1 {n}\n3 1 0 {n}\n",
             "\n".join(map(str, range(1, n + 1))) + "\n",
             "\n".join(" ".join(map(repr, p)) for p in
                       np.asarray(mesh.node_positions).tolist()) + "\n",
             "$EndNodes\n"]
    blocks = []
    for group in (1, 2):
        for count, gtype in ((3, 2), (4, 3)):
            idx = np.nonzero((mesh.surface_physical_group == group)
                             & (mesh.surface_node_counts == count))[0]
            if idx.size:
                body = np.column_stack([idx + 1, mesh.surfaces[idx, :count] + 1])
                blocks.append(f"2 {group} {gtype} {idx.size}\n" + rows(body))
    s = len(mesh.surfaces)
    count = int(mesh.element_node_counts[0])
    body = np.column_stack([np.arange(e) + s + 1, mesh.elements[:, :count] + 1])
    blocks.append(f"3 3 {5 if count == 8 else 4} {e}\n" + rows(body))
    parts.append(f"$Elements\n{len(blocks)} {e + s} 1 {e + s}\n")
    parts += blocks
    parts.append("$EndElements\n")
    return "".join(parts)


def same_mesh(label, a, b):
    for name in ("node_positions", "elements", "element_node_counts",
                 "element_physical_group", "surfaces", "surface_physical_group"):
        if not np.array_equal(getattr(a, name), getattr(b, name)):
            fail(f"{label}: {name} differs")
    for groups in ("surface_groups", "node_groups"):
        ga, gb = getattr(a, groups), getattr(b, groups)
        if set(ga) != set(gb) or any(not np.array_equal(ga[k], gb[k]) for k in ga):
            fail(f"{label}: {groups} differ")


def native_parser_phase():
    """Phase 32: the native Gmsh parser (``mesh/native.py`` over
    native/gmsh_fast.cpp) built with g++ on this machine (a missing
    toolchain fails the run), the 34^3 tet box written as Gmsh 4.1 text
    parsed natively and in Python (array for array equal, both timed),
    then the 66^3 tet box parsed natively (timed, against the mesh it was
    written from)."""
    import shutil

    from civiwave_tpu_torch.mesh import native
    from civiwave_tpu_torch.mesh.gmsh import load_gmsh_file
    from civiwave_tpu_torch.utils.synthetic import box_mesh

    t_phase = time.perf_counter()
    # built again here from the checkout's source, whatever an earlier
    # phase's Gmsh load built and loaded
    t0 = time.perf_counter()
    if not native.build_library() or not native.available():
        fail("native Gmsh parser: g++ did not build native/gmsh_fast.cpp")
    build_s = time.perf_counter() - t0
    tmp = scratch_dir("gmsh")
    times = {}
    try:
        for n in (34, GENERAL_N):
            mesh = box_mesh(n, n, n, hex_elements=False)
            path = os.path.join(tmp, f"box{n}.msh")
            t0 = time.perf_counter()
            with open(path, "w", encoding="ascii") as f:
                f.write(gmsh_text(mesh))
            write_s = time.perf_counter() - t0
            native.reset_counts()
            t0 = time.perf_counter()
            got = load_gmsh_file(path, use_native=True)
            native_s = time.perf_counter() - t0
            if (native.parse_nodes_section.calls,
                    native.parse_elements_section.calls) != (1, 1):
                fail(f"native Gmsh parser {n}^3: the native parse did not run")
            if not (np.array_equal(got.node_positions, mesh.node_positions)
                    and np.array_equal(got.elements, mesh.elements)):
                fail(f"native Gmsh parser {n}^3: not the mesh written")
            python_s = None
            if n == 34:
                t0 = time.perf_counter()
                plain = load_gmsh_file(path, use_native=False)
                python_s = time.perf_counter() - t0
                same_mesh(f"native Gmsh parser {n}^3 against Python", got, plain)
            times[n] = dict(native_s=native_s, python_s=python_s,
                            bytes=os.path.getsize(path))
            print(f"native Gmsh parser tet {n}^3 ({mesh.node_count:,} nodes, "
                  f"{mesh.element_count:,} tets, {times[n]['bytes']:,} bytes "
                  f"written in {write_s:.2f} s): native {native_s:.3f} s"
                  + ("" if python_s is None else
                     f", Python {python_s:.3f} s ({python_s / native_s:.1f}x), "
                     f"array for array equal"), flush=True)
            del mesh, got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 32: g++ build {build_s:.2f} s -> {native.LIB_PATH}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(build_s=build_s, **{f"tet{n}": v for n, v in times.items()})


def session_phase(device):
    """Phase 33: ``InteractiveSession`` on the 255^3 cantilever (two equal
    point-load requests bit-equal, reset exact, K2 launched, each solve's
    round trip timed), then ``viewer.start_in_thread`` on the 66^3 tet
    cantilever on the card: the page, the mesh, a solve with a point load,
    reset, round-trip seconds."""
    import json as json_
    import urllib.request

    from civiwave_tpu_torch.runner import build_simulation
    from civiwave_tpu_torch.ui import InteractiveSession, PointLoadRequest, viewer
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    t_phase = time.perf_counter()
    cfg = cantilever_config(tol_runtime=2e-4, max_iters=120, dt=1e-3,
                            adaptive=False,
                            mesh={"path": "synthetic://box/%d,%d,%d" % FULL})
    sim = build_simulation(cfg, device=device)
    session = InteractiveSession(sim)

    def snapshot():
        st = sim.stepper.state
        return {k: getattr(st, k).clone() for k in
                ("displacement", "velocity", "acceleration", "warm_x")}

    baseline = snapshot()
    request = PointLoadRequest(enabled=True, anchor=sim.model.node_count - 1,
                               direction=(0.0, 0.3, -1.0),
                               magnitude_newtons=5e5)
    reset_structured_counts()
    states, session_s, iters = [], [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tel, derived = session.solve(request)
        torch.cuda.synchronize()
        session_s.append(time.perf_counter() - t0)
        iters.append(tel.pcg_iterations)
        if not tel.pcg_converged or not np.isfinite(derived.node_von_mises).all():
            fail(f"session 255^3: solve not converged or non-finite: {tel}")
        states.append(snapshot())
    counts = structured_counts()
    for name, a in states[0].items():
        if not torch.equal(a, states[1][name]):
            fail(f"session 255^3: two equal requests differ in {name}")
    if counts["pc"] == 0:
        fail(f"session 255^3: K2 never launched ({counts})")
    session.reset()
    for name, a in snapshot().items():
        if not torch.equal(a, baseline[name]):
            fail(f"session 255^3: reset left {name} off the baseline")
    print(f"session 255^3: two equal point-load solves bit-equal, "
          f"{iters} iterations, round trips " + ", ".join(
              f"{t:.3f}" for t in session_s) + f" s (step + derived fields to "
          f"the host); reset exact; launches {counts}", flush=True)
    del sim, session, states, baseline
    torch.cuda.empty_cache()

    n = GENERAL_N
    cfg = cantilever_config(mesh={"path": f"synthetic://box/{n},{n},{n},tet"},
                            dt=1e-3, adaptive=False, tol_runtime=2e-4,
                            max_iters=300)
    t0 = time.perf_counter()
    sim = build_simulation(cfg, device=device)
    server, backend, _ = viewer.start_in_thread(sim, port=0)
    start_s = time.perf_counter() - t0
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"

        def call(path, body=None):
            t = time.perf_counter()
            req = urllib.request.Request(base + path, data=body,
                                         method="GET" if body is None else "POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                blob = r.read()
                header = r.headers.get("X-Civiwave")
            return blob, header and json_.loads(header), time.perf_counter() - t

        page, _, page_s = call("/")
        mesh_blob, mesh_hdr, mesh_s = call("/mesh")
        nodes = backend.node_count
        if b"webgl2" not in page or mesh_hdr["nodes"] != nodes or len(
                mesh_blob) != 12 * (nodes + mesh_hdr["tris"]):
            fail(f"viewer tet {n}^3: page or mesh blob wrong ({mesh_hdr})")
        solve_blob, tele, viewer_s = call("/solve", json_.dumps(
            {"enabled": True, "anchor": nodes - 1, "direction": [0, 0, -1],
             "magnitude": 1e6}).encode())
        u = np.frombuffer(solve_blob, np.float32, nodes * 3)
        if not tele["converged"] or len(solve_blob) != 16 * nodes or not (
                np.isfinite(u).all() and np.abs(u).max() > 0):
            fail(f"viewer tet {n}^3: solve round trip wrong ({tele})")
        _, _, reset_s = call("/reset", b"")
        if np.abs(backend.sim.stepper.displacement()).max() != 0.0:
            fail(f"viewer tet {n}^3: reset left a displacement")
    finally:
        server.shutdown()
        server.server_close()
    print(f"viewer tet {n}^3 on {device}: build + start {start_s:.2f} s "
          f"({nodes:,} nodes, {mesh_hdr['tris']:,} surface triangles); page "
          f"{page_s:.3f} s, mesh {mesh_s:.3f} s ({len(mesh_blob):,} bytes), solve "
          f"with a point load {viewer_s:.3f} s ({tele['iterations']} iterations, "
          f"server-side {tele['solve_ms']} ms), reset {reset_s:.3f} s", flush=True)
    del sim, backend
    torch.cuda.empty_cache()
    print(f"phase 33: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(session_s=session_s, session_iters=iters,
                session_pc=counts["pc"], viewer_s=viewer_s,
                viewer_solve_ms=tele["solve_ms"], viewer_start_s=start_s)


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke run needs "
              "a CUDA GPU", file=sys.stderr)
        return 1
    # the port itself: missing next to this script means nothing to test
    from civiwave_tpu_torch.ops.cuda import _build

    torch.manual_seed(SEED)
    device = torch.device("cuda", 0)
    # the card's name and power limit exactly as nvidia-smi prints them
    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    lib = _build.load_library()
    print(f"build: {lib.build_seconds:.2f} s nvcc -> {lib.path.name}", flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    # the whole-iteration path is opt-in: phases 4b and 5's second run set
    # the switch for themselves, every other phase runs without it
    os.environ.pop(MEGA, None)
    errs, times = kernel_phase(device)
    launches, split = main_path_phase(device)
    mega_launches = mega_main_path_phase(device, split)
    trajectory_phase(device)
    trajectory_phase(device, mega=True)

    from civiwave_tpu_torch.physics import materials
    from civiwave_tpu_torch.solver.stepper import effective_scalars
    from civiwave_tpu_torch.utils.synthetic import cantilever_config

    ray = materials.compute_rayleigh(cantilever_config().damping)
    ss, mf = effective_scalars(1.0e-3, ray.alpha, ray.beta)
    general_small_kernel_phase(device, ss, mf)
    hex_errs, hex_timing, g1_hex, gdofs = general_matvec_phase(device, ss, mf)
    tet_errs, tet_timings, main_counts, tet_classic = general_main_path_phase(
        device, ss, mf)
    steps_counts = general_steps_phase(device)
    column_trajectory_phase(device)
    slender_errs, slender_times = slender_kernel_phase(device, ss, mf)
    column_counts, column = column_main_path_phase(device)
    basin = basin_phase(device)
    halo_worst, halo_times = halo_kernel_phase(device, ss, mf)
    sharded = sharded_main_path_phase(device, split)
    static_tet_counts = static_example_phase(device)
    static = static_full_width_phase(device)
    box_output_phase(device)
    output = output_full_width_phase(device, split)
    basin_counts = tet_basin_phase(device)
    mg = multigrid_phase(device, split, static)
    pipelined = pipelined_phase(device, split, static, tet_classic)
    f64_errs, f64_times = f64_kernel_phase(
        device, times, hex32=dict(k7=hex_timing["ms"], g1=g1_hex["ms"]),
        tet32=dict(k7=tet_timings["element_forces_tet"]["ms"],
                   g1=tet_timings["assemble_csr"]["ms"]))
    fp64 = fp64_paths_phase(device, static, tet_classic, column)
    ckpt = checkpoint_phase(device)
    profile_cli_phase()
    general_halo_worst, general_halo_times = general_halo_phase(device, ss, mf)
    general_shard = general_sharded_main_path_phase(device, tet_classic)
    sharded_basin = sharded_basin_phase(device, basin)
    sharded_static = sharded_static_phase(device, static)
    del static["exact"], basin
    launch_across_gpus_phase()
    hetero_errs, hetero_times, hetero = heterogeneous_phase(device, ss, mf)
    shard_errs, shard_times, hetero_shard = hetero_shard_phase(
        device, ss, mf, hetero, halo_times["slab64"]["ms"])
    shard_out = shard_output_phase(device, output)
    parser = native_parser_phase()
    session = session_phase(device)

    src = "civiwave_tpu_torch/csrc/"
    pallas = "civiwave_tpu/ops/pallas/"
    nodes = int(np.prod([n + 1 for n in FULL]))

    def static_launches(key):
        """Launches of one kernel over phase 16c's three 255^3 static solves
        (fused, classic, megafused)."""
        return sum(static[v]["counts"][key] for v in ("fused", "classic", "megafused"))

    def structured_bound(key):
        ms, by = bound(KERNEL_BYTES_PER_NODE[key] * nodes,
                       KERNEL_FLOPS_PER_NODE[key] * nodes)
        return dict(bound_ms=ms, bound_by=by, library_ms=None)

    # structured errors and times at 255^3, general ones at the 66^3 shapes
    # of their paths; max_rel_err is max abs err / max|plain|, the quantity
    # held to OP_TOL.  launches: the structured main path for K1-K3, the
    # megafused main path for K6, the general main path (a) for K7 tet and
    # G1, the general steps workload (c) for K7 hex
    kernels = [
        dict(name="keff_structured", route="cuda",
             source=src + "keff_structured_halo.cu",
             replaces=pallas + "structured_stencil.py:931",
             launches=launches["keff"], max_abs_err=errs["keff"][0],
             max_rel_err=errs["keff"][1], tol=OP_TOL,
             ms=times["keff"][0], plain_ms=times["keff"][1],
             **structured_bound("keff"),
             launches_static=static_launches("keff"),
             launches_multigrid=mg["counts"]["keff"],
             launches_multigrid_static=mg["static"]["counts"]["keff"],
             max_rel_err_multigrid_levels=mg["level_err"][1],
             launches_pipelined=pipelined["counts"]["keff"]),
        dict(name="pc_keff_structured", route="cuda",
             source=src + "pc_keff_structured.cu",
             replaces=pallas + "structured_stencil.py:820",
             launches=launches["pc"],
             max_abs_err=max(errs["pc_u"][0], errs["pc_w"][0]),
             max_rel_err=max(errs["pc_u"][1], errs["pc_w"][1]), tol=OP_TOL,
             ms=times["pc"][0], plain_ms=times["pc"][1],
             **structured_bound("pc"),
             launches_static=static_launches("pc"),
             launches_pipelined=pipelined["counts"]["pc"],
             launches_pipelined_static=pipelined["static"]["counts"]["pc"],
             launches_session=session["session_pc"]),
        dict(name="block_jacobi_apply", route="cuda",
             source=src + "block_jacobi_apply.cu",
             replaces=pallas + "block_jacobi_apply.py:144",
             launches=launches["bj"], max_abs_err=errs["bj"][0],
             max_rel_err=errs["bj"][1], tol=OP_TOL,
             ms=times["bj"][0], plain_ms=times["bj"][1],
             **structured_bound("bj"),
             launches_static=static_launches("bj"),
             launches_pipelined_shard=pipelined["shard"]["counts"]["bj"],
             launches_sharded_basin=sharded_basin["counts"]["bj"],
             launches_sharded_static=sharded_static["counts"]["bj"],
             launches_shard_output=shard_out["1-D"]["counts"]["bj"]),
        dict(name="pcg_iteration_structured", route="cuda",
             source=src + "pcg_iteration_structured.cu",
             replaces=pallas + "structured_stencil.py:1226",
             launches=mega_launches["k6"], max_abs_err=errs["k6"][0],
             max_rel_err=errs["k6"][1], tol=OP_TOL,
             ms=times["k6"][0], plain_ms=times["k6"][1],
             **structured_bound("k6"),
             launches_static=static_launches("k6")),
        # U1, the fused loop's direction update (phase 4's U1 block at
        # (3, 256, 256, 256)): bit-equal to its plain version (errors 0), its
        # time on later calls with the first call's beside it, launches on
        # the main path's 8 fused frames (one per PCG iteration)
        dict(name="cg_direction_update", route="cuda",
             source=src + "pcg_vector_update.cu",
             replaces="civiwave_tpu/solver/pcg.py:484", launches=launches["u1"],
             max_abs_err=0.0, max_rel_err=0.0, tol=0.0, bit_equal=True,
             **split["u1"]["f32"],
             ms_f64=split["u1"]["f64"]["ms"],
             ms_first_f64=split["u1"]["f64"]["ms_first"],
             plain_ms_f64=split["u1"]["f64"]["plain_ms"],
             bound_ms_f64=split["u1"]["f64"]["bound_ms"]),
        # the stepper's three passes (phase 4's block): each bit-equal to
        # its plain version (errors 0) on the three layouts; the summed
        # time and bound at (3, 256, 256, 256) (1.057 ms in f32, 2.07 in
        # f64) and, under "layouts", on the other two; launches of the
        # three over the main path's 10 frames (once a frame each)
        dict(name="newmark_vectors", route="cuda",
             source=src + "newmark_vectors.cu",
             replaces="civiwave_tpu/solver/stepper.py:161",
             launches=launches["newmark"],
             max_abs_err=0.0, max_rel_err=0.0, tol=0.0, bit_equal=True,
             **split["newmark"]["255^3"]["f32"],
             ms_f64=split["newmark"]["255^3"]["f64"]["ms"],
             plain_ms_f64=split["newmark"]["255^3"]["f64"]["plain_ms"],
             bound_ms_f64=split["newmark"]["255^3"]["f64"]["bound_ms"],
             passes_f64=split["newmark"]["255^3"]["f64"]["passes"],
             layouts={layout: {label: {key: r[key] for key in ("ms", "bound_ms")}
                               for label, r in by_dtype.items()}
                      for layout, by_dtype in split["newmark"].items()
                      if layout != "255^3"}),
        dict(name="element_forces_hex", route="cuda",
             source=src + "element_forces.cu",
             replaces=pallas + "element_forces.py:125",
             launches=steps_counts["element_forces_hex"],
             max_abs_err=hex_errs["element_forces_hex"][0],
             max_rel_err=hex_errs["element_forces_hex"][1], tol=OP_TOL,
             **hex_timing),
        dict(name="element_forces_tet", route="cuda",
             source=src + "element_forces.cu",
             replaces=pallas + "element_forces.py:130",
             launches=main_counts["element_forces_tet"],
             max_abs_err=tet_errs["element_forces_tet"][0],
             max_rel_err=tet_errs["element_forces_tet"][1], tol=OP_TOL,
             **tet_timings["element_forces_tet"],
             launches_static=static_tet_counts["element_forces_tet"],
             launches_tet_basin=basin_counts["element_forces_tet"],
             launches_pipelined=pipelined["general"]["counts"]["element_forces_tet"],
             launches_general_shard=general_shard["counts"]["element_forces_tet"],
             max_rel_err_halo_shards=general_halo_worst[1],
             ms_halo_shard8=general_halo_times[("tet", 8)]["max_ms"],
             launches_shard_output=shard_out["general"]["counts"]["element_forces_tet"]),
        dict(name="assemble_csr", route="cuda", source=src + "assemble_csr.cu",
             replaces="civiwave_tpu/ops/apply_keff.py:283",
             launches=main_counts["assemble_csr"],
             max_abs_err=tet_errs["assemble_csr"][0],
             max_rel_err=tet_errs["assemble_csr"][1], tol=OP_TOL,
             **tet_timings["assemble_csr"], ms_hex66=g1_hex["ms"],
             bound_ms_hex66=g1_hex["bound_ms"],
             launches_static=static_tet_counts["assemble_csr"],
             launches_tet_basin=basin_counts["assemble_csr"],
             launches_pipelined=pipelined["general"]["counts"]["assemble_csr"],
             launches_general_shard=general_shard["counts"]["assemble_csr"],
             launches_shard_output=shard_out["general"]["counts"]["assemble_csr"]),
        # K4 and G2: errors over every grid of phase 11, device times at the
        # soil column's grid (and at 255^3), launches on its main path
        # (phase 12)
        dict(name="interior_stencil", route="cuda",
             source=src + "interior_stencil.cu",
             replaces=pallas + "structured_stencil.py:110",
             launches=column_counts["k4"], max_abs_err=slender_errs["k4"][0],
             max_rel_err=slender_errs["k4"][1], tol=OP_TOL,
             **slender_times["soil column"]["k4"],
             ms_255=slender_times["255x255x255"]["k4"]["ms"],
             bound_ms_255=slender_times["255x255x255"]["k4"]["bound_ms"]),
        dict(name="keff_boundary", route="cuda", source=src + "keff_boundary.cu",
             replaces="civiwave_tpu/ops/structured.py:449",
             launches=column_counts["g2"], max_abs_err=slender_errs["g2"][0],
             max_rel_err=slender_errs["g2"][1], tol=OP_TOL,
             **slender_times["soil column"]["g2"],
             ms_255=slender_times["255x255x255"]["g2"]["ms"],
             bound_ms_255=slender_times["255x255x255"]["g2"]["bound_ms"]),
        # K5: errors over every grid of phase 14, the time of one launch on
        # the 256-plane slab of the main path (and on a 64-plane slab),
        # launches on the sharded main path (phase 15)
        dict(name="keff_structured_halo", route="cuda",
             source=src + "keff_structured_halo.cu",
             replaces=pallas + "structured_stencil.py:968",
             launches=sharded["counts"]["k5"], max_abs_err=halo_worst[0],
             max_rel_err=halo_worst[1], tol=OP_TOL,
             ms=halo_times["slab256"]["ms"],
             plain_ms=halo_times["slab256"]["plain_ms"],
             bound_ms=halo_times["slab256"]["bound_ms"],
             bound_by=halo_times["slab256"]["bound_by"], library_ms=None,
             ms_split=halo_times["slab256"]["split_ms"],
             ms_slab64=halo_times["slab64"]["ms"],
             bound_ms_slab64=halo_times["slab64"]["bound_ms"],
             launches_pipelined_shard=pipelined["shard"]["counts"]["k5"],
             launches_sharded_basin=sharded_basin["counts"]["k5"],
             launches_sharded_static=sharded_static["counts"]["k5"],
             launches_shard_output=shard_out["1-D"]["counts"]["k5"],
             launches_shard_output_2d=shard_out["2-D"]["counts"]["k5"]),
        # the f64 instances (phases 20-21): errors against the plain
        # versions in f64 (tol F64_TOL), times at the main-path shapes with
        # the f32 instance's beside them, bounds at the f64 rate, launches
        # on their fp64 paths: the 255^3 cantilever (K1, K3), the one-rank
        # shard (K5), the 66^3 tet cantilever (K7 tet, G1) and the shuffled
        # 34^3 hex box (K7 hex)
        dict(name="keff_structured_f64", route="cuda",
             source=src + "keff_structured_halo.cu",
             replaces=pallas + "structured_stencil.py:931",
             launches=fp64["full"]["counts"]["keff_f64"],
             max_abs_err=f64_errs["keff"][0], max_rel_err=f64_errs["keff"][1],
             tol=F64_TOL, **f64_times["keff"], ms_f32=times["keff"][0],
             launches_static=fp64["static"]["counts"]["keff_f64"]),
        dict(name="keff_structured_halo_f64", route="cuda",
             source=src + "keff_structured_halo.cu",
             replaces=pallas + "structured_stencil.py:968",
             launches=fp64["shard"]["counts"]["k5_f64"],
             max_abs_err=f64_errs["k5"][0], max_rel_err=f64_errs["k5"][1],
             tol=F64_TOL, **f64_times["k5"], ms_f32=halo_times["slab64"]["ms"]),
        dict(name="block_jacobi_apply_f64", route="cuda",
             source=src + "block_jacobi_apply.cu",
             replaces=pallas + "block_jacobi_apply.py:144",
             launches=fp64["full"]["counts"]["bj_f64"],
             max_abs_err=f64_errs["bj"][0], max_rel_err=f64_errs["bj"][1],
             tol=F64_TOL, **f64_times["bj"], ms_f32=times["bj"][0]),
        dict(name="element_forces_tet_f64", route="cuda",
             source=src + "element_forces.cu",
             replaces=pallas + "element_forces.py:130",
             launches=fp64["tet"]["counts"]["tet_f64"],
             max_abs_err=f64_errs["tet"][0], max_rel_err=f64_errs["tet"][1],
             tol=F64_TOL, **f64_times["tet"],
             ms_f32=tet_timings["element_forces_tet"]["ms"]),
        dict(name="element_forces_hex_f64", route="cuda",
             source=src + "element_forces.cu",
             replaces=pallas + "element_forces.py:125",
             launches=fp64["hex"]["counts"]["hex_f64"],
             max_abs_err=f64_errs["hex"][0], max_rel_err=f64_errs["hex"][1],
             tol=F64_TOL, **f64_times["hex"], ms_f32=hex_timing["ms"]),
        dict(name="assemble_csr_f64", route="cuda", source=src + "assemble_csr.cu",
             replaces="civiwave_tpu/ops/apply_keff.py:283",
             launches=fp64["tet"]["counts"]["g1_f64"],
             max_abs_err=max(f64_errs["g1_tet"][0], f64_errs["g1_hex"][0]),
             max_rel_err=max(f64_errs["g1_tet"][1], f64_errs["g1_hex"][1]),
             tol=F64_TOL, **f64_times["g1_tet"],
             ms_f32=tet_timings["assemble_csr"]["ms"],
             ms_hex66=f64_times["g1_hex"]["ms"],
             launches_hex=fp64["hex"]["counts"]["g1_f64"]),
    ]
    print(f"general_matvec_throughput {gdofs:.4f} GDOF/s", flush=True)
    print("static 255^3 " + "; ".join(
        f"{v}: {static[v]['iterations']} iterations, {static[v]['seconds']:.4f} s"
        for v in ("fused", "classic", "megafused")) + f"; output 255^3 "
        f"{output['steps_per_s']:.4f} steps/s with output vs "
        f"{split['steps_per_s']:.4f} without", flush=True)
    print(f"multigrid 255^3: {mg['steps_per_s']:.4f} steps/s, "
          f"{mg['ms_per_iter']:.4f} ms per iteration, iterations {mg['iters']}; "
          f"static {mg['static']['iterations']} iterations, "
          f"{mg['static']['seconds']:.4f} s; pipelined 255^3: "
          f"{pipelined['steps_per_s']:.4f} steps/s, {pipelined['ms_per_iter']:.4f} "
          f"ms per iteration; static {pipelined['static']['iterations']} "
          f"iterations (converged {pipelined['static']['converged']}), "
          f"{pipelined['static']['seconds']:.4f} s", flush=True)
    print(f"fp64 255^3: {fp64['full']['steps_per_s']:.4f} steps/s, "
          f"{fp64['full']['ms_per_iter']:.4f} ms per iteration; fp64 static 255^3: "
          f"{fp64['static']['iterations']} iterations, {fp64['static']['seconds']:.4f} "
          f"s, {fp64['static']['dist']:.3e} of max|u| from the refined u; fp64 tet "
          f"66^3: {fp64['tet']['steps_per_s']:.4f} steps/s; resume at 255^3 bit-equal "
          f"(checkpoint {ckpt['bytes']:,} bytes, save {ckpt['save_s']:.3f} s, restore "
          f"{ckpt['restore_s']:.3f} s)", flush=True)
    print(f"sharded static 255^3 (one rank, classic): "
          f"{sharded_static['iterations']} iterations, "
          f"{sharded_static['seconds']:.4f} s, {sharded_static['err']:.3e} of "
          f"max|u| from the refined u; general halo cuts K7 + G1 per shard "
          f"(max over shards, ms): " + ", ".join(
              f"{k[0]}/{k[1]} {v['max_ms']:.4f} (whole {v['whole_ms']:.4f})"
              for k, v in general_halo_times.items()), flush=True)
    # G3 (phase 29): errors and times at 255^3 (the torch-composition
    # yardstick beside them, not a library call: no single PyTorch call
    # computes G3), the worst error over G3_SHAPES, registers and spill
    # bytes, launches on the heterogeneous 255^3 cantilever's 8 frames
    # (f32) and 3 fp64 frames
    kernels += [
        dict(name="corner_gather", route="cuda", source=src + "corner_gather.cu",
             replaces="civiwave_tpu/ops/structured.py:503",
             launches=hetero["counts"]["g3"], max_abs_err=hetero_errs["f32"][0],
             max_rel_err=hetero_errs["f32"][1], tol=OP_TOL,
             **hetero_times["f32"], max_rel_err_vs_k1=hetero_errs["vs_k1"][1],
             launches_static=hetero["static"]["g3"]),
        dict(name="corner_gather_f64", route="cuda",
             source=src + "corner_gather.cu",
             replaces="civiwave_tpu/ops/structured.py:503",
             launches=hetero["fp64"]["counts"]["g3_f64"],
             max_abs_err=hetero_errs["f64"][0],
             max_rel_err=hetero_errs["f64"][1], tol=F64_TOL,
             **hetero_times["f64"], ms_f32=hetero_times["f32"]["ms"]),
        # G3 on a shard (phase 30): the worst error over the shards of the
        # 255^3 cuts against the plain shard version, the time of one
        # launch on an inner 64-plane slab, launches on the one-rank 1-D
        # shard's 8 frames (3 per matvec: the overlap split) and its 3
        # fp64 frames
        dict(name="corner_gather_shard", route="cuda",
             source=src + "corner_gather.cu",
             replaces="civiwave_tpu/ops/structured.py:503",
             launches=hetero_shard["1-D"]["counts"]["g3"],
             max_abs_err=shard_errs["f32"][0], max_rel_err=shard_errs["f32"][1],
             tol=OP_TOL, **shard_times["f32"],
             launches_2d=hetero_shard["2-D"]["counts"]["g3"],
             launches_static=hetero_shard["static"]["g3"],
             launches_shard_output=shard_out["hetero"]["g3"]),
        dict(name="corner_gather_shard_f64", route="cuda",
             source=src + "corner_gather.cu",
             replaces="civiwave_tpu/ops/structured.py:503",
             launches=hetero_shard["fp64"]["g3_f64"],
             max_abs_err=shard_errs["f64"][0], max_rel_err=shard_errs["f64"][1],
             tol=F64_TOL, **shard_times["f64"],
             ms_f32=shard_times["f32"]["ms"]),
    ]
    print(f"heterogeneous 255^3: {hetero['steps_per_s']:.4f} steps/s, "
          f"{hetero['ms_per_iter']:.4f} ms per iteration, iterations "
          f"{hetero['iters']}, per-node pc apply {hetero['pc_apply_ms']:.4f} ms; "
          f"static {hetero['static']['iterations']} iterations, "
          f"{hetero['static']['seconds']:.4f} s", flush=True)
    print(f"heterogeneous shard 255^3 (one rank): 1-D "
          f"{hetero_shard['1-D']['steps_per_s']:.4f} steps/s, "
          f"{hetero_shard['1-D']['ms_per_iter']:.4f} ms per iteration; 2-D "
          f"{hetero_shard['2-D']['steps_per_s']:.4f}, "
          f"{hetero_shard['2-D']['ms_per_iter']:.4f}; unsharded fused "
          f"{hetero_shard['fused']['steps_per_s']:.4f}, "
          f"{hetero_shard['fused']['ms_per_iter']:.4f}; static "
          f"{hetero_shard['static']['iterations']} iterations, "
          f"{hetero_shard['static']['seconds']:.4f} s", flush=True)
    one, two = shard_out["1-D"], shard_out["2-D"]
    print(f"shard output 255^3 (one rank): 1-D {one['steps_per_s']:.4f} steps/s, "
          f"2-D {two['steps_per_s']:.4f} (frames 2-8 with a VTU in flight and a "
          f"checkpoint; without the checkpoint frame {one['steps_no_ckpt']:.4f} / "
          f"{two['steps_no_ckpt']:.4f}; "
          f"phase 17b unsharded {output['steps_per_s']:.4f}); derived fields "
          f"{one['derived_ms']:.4f} / {two['derived_ms']:.4f} ms, probes "
          f"{one['probe_ms']:.4f} / {two['probe_ms']:.4f} ms per frame, VTU "
          f"{one['vtu_write_s']:.3f} / {two['vtu_write_s']:.3f} s; checkpoint "
          f"{one['ckpt_bytes']:,} bytes, save {one['save_s']:.3f} s, restore "
          f"{one['restore_s']:.3f} s; heterogeneous 1-D "
          f"{shard_out['hetero']['steps_per_s']:.4f} steps/s; native Gmsh parse "
          f"tet 34^3 {parser['tet34']['native_s']:.3f} s (Python "
          f"{parser['tet34']['python_s']:.3f} s), tet {GENERAL_N}^3 "
          f"{parser[f'tet{GENERAL_N}']['native_s']:.3f} s; session 255^3 round "
          f"trips {', '.join(f'{t:.3f}' for t in session['session_s'])} s; viewer "
          f"tet {GENERAL_N}^3 solve round trip {session['viewer_s']:.3f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
