#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result:

1. require CUDA; print the card (``nvidia-smi`` name and power limit);
2. build the kernels from ``civiwave_tpu_torch/csrc`` with nvcc (sm_90a);
3. hold each kernel (K1 keff_structured, K2 pc_keff_structured with and
   without dots, K3 block_jacobi_apply) against its plain PyTorch version
   on small grids, an odd grid with fixes on several faces and the full
   255^3-cell grid, and time kernel and plain version with CUDA events;
4. drive the port's main path at full width — ``build_simulation`` on the
   255^3-cell steel cantilever (50,331,648 DOF) — for 8 frames on the
   'auto' (fused) PCG and 2 on 'classic', and check that every frame
   converged, the state is finite and every kernel was launched;
5. run the cantilever_box example (24x8x8, gravity, curve-ramped traction,
   adaptive dt) for 10 frames on the GPU and on the CPU (plain versions)
   and compare the trajectories.

Any failed check exits non-zero.  The last two lines of stdout are a JSON
summary of the kernels and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
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
# (12 B) and the mask (3 B) and write one vector; K2 writes two
KERNEL_BYTES_PER_NODE = {"keff": 27, "bj": 27, "pc": 39}
HBM_TBPS = 3.35  # H100 SXM published device-memory bandwidth at 700 W


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
        print(f"kernels vs plain [{label}] abs/rel err: " + ", ".join(
            f"{k}={a:.3e}/{r:.2e}" for k, (a, r) in errs.items()), flush=True)
        results[label] = (model, pc, x, errs)

    model, pc, x, errs = results["255x255x255"]
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
    del results, model, pc, x
    torch.cuda.empty_cache()
    return errs, times


def main_path_phase(device):
    """Phase 4: the port's main path at full width."""
    from civiwave_tpu_torch.ops.cuda import block_jacobi_apply as k3
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

    frame_s, telemetries = [], []
    for variant, frames in (("auto", 8), ("classic", 2)):
        sim.stepper.solver_variant = variant
        for _ in range(frames):
            t0 = time.perf_counter()
            telemetries += sim.run(1)
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)

    launches = {
        "keff": k12.apply_keff_fused.launches,
        "pc": k12.apply_pc_keff_fused.launches,
        "bj": k3.apply_block_jacobi.launches,
    }
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
    print(f"main path: peak device memory {peak / 2**30:.3f} GiB "
          f"({peak} bytes)", flush=True)
    print(f"main path: kernel launches {launches}; tip u_z {tip:.6e} m",
          flush=True)
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


def trajectory_phase(device):
    """Phase 5: the example scenario on the GPU against the CPU."""
    from civiwave_tpu_torch.runner import build_simulation

    cfg = cantilever_box_config()
    runs = {}
    for dev in (device, "cpu"):
        sim = build_simulation(cfg, device=dev)
        tel = sim.run(10)
        runs[dev] = (tel, sim.stepper.state)
    (tg, sg), (tc, sc) = runs[device], runs["cpu"]
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
    print(f"cantilever_box 10 frames: iterations gpu {it_g} cpu {it_c}; "
          f"max abs err / max|cpu| u {errs['displacement']:.3e} "
          f"(tol {U_TOL:g}), a {errs['acceleration']:.3e} (tol {A_TOL:g})",
          flush=True)


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

    errs, times = kernel_phase(device)
    launches = main_path_phase(device)
    trajectory_phase(device)

    src = "civiwave_tpu_torch/csrc/"
    pallas = "civiwave_tpu/ops/pallas/"
    # errors and times at 255^3; max_rel_err is max abs err / max|plain|,
    # the quantity held to OP_TOL
    kernels = [
        dict(name="keff_structured", route="cuda", source=src + "keff_structured.cu",
             replaces=pallas + "structured_stencil.py:931",
             launches=launches["keff"], max_abs_err=errs["keff"][0],
             max_rel_err=errs["keff"][1], tol=OP_TOL,
             ms=times["keff"][0], plain_ms=times["keff"][1]),
        dict(name="pc_keff_structured", route="cuda",
             source=src + "pc_keff_structured.cu",
             replaces=pallas + "structured_stencil.py:820",
             launches=launches["pc"],
             max_abs_err=max(errs["pc_u"][0], errs["pc_w"][0]),
             max_rel_err=max(errs["pc_u"][1], errs["pc_w"][1]), tol=OP_TOL,
             ms=times["pc"][0], plain_ms=times["pc"][1]),
        dict(name="block_jacobi_apply", route="cuda",
             source=src + "block_jacobi_apply.cu",
             replaces=pallas + "block_jacobi_apply.py:144",
             launches=launches["bj"], max_abs_err=errs["bj"][0],
             max_rel_err=errs["bj"][1], tol=OP_TOL,
             ms=times["bj"][0], plain_ms=times["bj"][1]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
