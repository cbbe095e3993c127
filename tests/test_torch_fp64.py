"""``precision.vectors: fp64`` in the port against the JAX package, on the CPU.

fp64 is the accuracy mode of the reference (its Pallas kernels decline f64
and its XLA forms run it); the port runs it through the same entry points,
on CUDA through the f64 instances of K1/K5, K3, K7 and G1 (held against
their plain versions by ``tests/test_torch_kernels_cuda.py``), here through
the plain versions.  The same scenarios go through both packages:

* ``examples/cantilever_box.yaml`` in fp64 at tol 1e-10 (structured route,
  curve-ramped traction, adaptive dt), a 6x3x3 tet box (general path), the
  box under the multigrid preconditioner, and the static example;
* two gloo ranks of the sharded route against the port's unsharded fp64
  run;
* the reference's oracle test (``tests/test_stepper.py:183-229``): fp64
  within 1e-6 of the dense f64 oracle, and tighter than fp32.

Tolerances: PCG iterations within +-1 per frame and u within 1e-7 of
max|u| (an f32 round trip anywhere on the path shows at ~1e-5).  Plus the
CPU-side geometry of the f64 sweep: shared memory by element size against
the C formula, the 16-byte-copy rule and the f64 taps.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from civiwave_tpu.runner import build_simulation as jbuild_simulation
from civiwave_tpu.solver.static import solve_static as jsolve_static
from civiwave_tpu_torch.mesh import pack, preprocess
from civiwave_tpu_torch.ops import structured as tops
from civiwave_tpu_torch.ops.cuda import plane_sweep
from civiwave_tpu_torch.physics import materials, newmark, oracle
from civiwave_tpu_torch.runner import build_simulation, run_static
from civiwave_tpu_torch.solver.stepper import NewmarkStepper
from civiwave_tpu_torch.utils import synthetic

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_YAML = os.path.join(REPO, "examples", "cantilever_box.yaml")
STATIC_YAML = os.path.join(REPO, "examples", "static_cantilever.yaml")
U_TOL = 1e-7  # of max|u|
JOIN_TIMEOUT = 120  # seconds for the spawned ranks


def fp64_yaml(tmp_path, src=BOX_YAML, name="fp64.yaml", **subs):
    """``src`` with vectors fp64, the runtime tolerance 1e-10 and the
    replacements ``subs`` (old text -> new text), written under tmp_path."""
    with open(src, encoding="utf-8") as f:
        text = f.read()
    subs = {"vectors: fp32": "vectors: fp64",
            "tol_runtime: 2.0e-4": "tol_runtime: 1.0e-10", **subs}
    for old, new in subs.items():
        assert old in text, old
        text = text.replace(old, new)
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def assert_u_close(got, ref, tol=U_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(got - ref).max() / scale
    assert err <= tol, f"u differs by {err:.3e} of max|u|"
    return err


def run_both(path, frames):
    """(port telemetry, port nodal u, reference telemetry, reference u)."""
    sim = build_simulation(path, device="cpu")
    tel = sim.run(frames)
    assert sim.stepper.state.displacement.dtype == torch.float64
    jsim = jbuild_simulation(path)
    jtel = jsim.run(frames)
    return tel, sim.stepper.displacement(), jtel, np.asarray(jsim.stepper.displacement())


def assert_iterations_close(tel, jtel):
    iters = [t.pcg_iterations for t in tel]
    ref = [t.pcg_iterations for t in jtel]
    assert all(abs(a - b) <= 1 for a, b in zip(iters, ref)), (iters, ref)
    # at 1e-10 the box's first frame ends on the reference's rho breakdown
    # (|rho| < 1e-18 before the residual test passes) in both packages
    assert [t.pcg_converged for t in tel] == [t.pcg_converged for t in jtel]
    assert [t.pcg_breakdown for t in tel] == [t.pcg_breakdown for t in jtel]
    return iters


@pytest.mark.parametrize(
    "subs, frames",
    [
        ({}, 5),
        ({'path: "synthetic://box/24,8,8"': 'path: "synthetic://box/6,3,3,tet"'}, 5),
        # one frame: the reference's multigrid step takes ~60 s per frame
        # on the CPU
        ({"preconditioner: block_jacobi": "preconditioner: multigrid",
          'path: "synthetic://box/24,8,8"': 'path: "synthetic://box/12,6,6"'}, 1),
    ],
    ids=["structured_box", "tet_box_general", "multigrid_box"],
)
def test_fp64_frames_match_reference(tmp_path, subs, frames):
    path = fp64_yaml(tmp_path, **subs)
    tel, u, jtel, ju = run_both(path, frames)
    assert_iterations_close(tel, jtel)
    assert [t.time_step for t in tel] == [t.time_step for t in jtel]
    assert_u_close(u, ju)


def test_fp64_static_matches_reference(tmp_path):
    """The static example in fp64 through run_static, against the
    reference's solve_static in fp64 on its own model.  Op by op, not
    jitted: XLA's compiled loop rounds a few operations otherwise (2.8e-8
    of max|u| apart after 5 iterations), and on this residual's plateau
    near 1e-8 that moves the stop from 168 to 200 iterations."""
    path = fp64_yaml(tmp_path, STATIC_YAML)
    sim = build_simulation(path, device="cpu")
    u, payload = run_static(sim)
    assert payload["converged"] and u.dtype == torch.float64
    jsim = jbuild_simulation(path)
    cfg = jsim.config
    ju, jtel = jsolve_static(
        jsim.model, jsim.stepper.external_force,
        tolerance=cfg.solver.pause_tolerance,
        max_iterations=cfg.solver.max_iterations, vector_precision="fp64",
    )
    assert bool(jtel.converged)
    assert abs(payload["iterations"] - int(jtel.iterations)) <= 1
    assert_u_close(sim.stepper.displacement(),
                   np.asarray(jsim.model.to_nodal(ju)))


def test_fp64_two_gloo_ranks_match_unsharded(tmp_path):
    """cantilever_box in fp64 over two gloo ranks (the sharded route: K5's
    and K3's plain versions with ghosts and offsets, one f64 all-reduce per
    fused iteration) against the port's unsharded fp64 run."""
    path = fp64_yaml(tmp_path)
    out = tmp_path / "frames.npz"
    cmd = [sys.executable, "-m", "civiwave_tpu_torch.parallel.launch",
           "--npx", "2", "--scenario", path, "--frames", "4", "--device", "cpu",
           "--init-method", f"file://{tmp_path / 'store'}",
           "--timeout", str(JOIN_TIMEOUT - 10), "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=JOIN_TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = np.load(out)
    ref = build_simulation(path, device="cpu")
    ref.stepper.solver_variant = "fused"  # 'auto' on a shard
    tel = ref.run(4)
    assert all(abs(int(a) - t.pcg_iterations) <= 1
               for a, t in zip(got["iterations"], tel))
    assert list(got["time_step"]) == [t.time_step for t in tel]
    assert_u_close(got["displacement"][-1], ref.stepper.displacement())


def test_fp64_vectors_reproduce_oracle_to_1e6():
    """The reference's test_fp64_vectors_reproduce_oracle_to_1e6 on the
    port: fp64 vectors reproduce the dense f64 oracle (the port's
    physics/oracle.py) to better than 1e-6 of max|u| after two frames,
    where fp32 lands in its 1e-4..1e-5 band; fp64 strictly tighter."""
    mesh = synthetic.box_mesh(3, 2, 2, hex_elements=True)
    # the reference's bar_config(tol_runtime=1e-12, ...) puts its overrides
    # beside the solver section, not in it, so its run solves at the
    # section's 1e-6 with 400 iterations: so does this one
    cfg = synthetic.cantilever_config(tol_runtime=1.0e-6, max_iters=400)
    pre = preprocess.run(mesh, cfg)
    mats = [materials.make_properties(m) for m in cfg.materials]
    ray = materials.compute_rayleigh(cfg.damping)

    results = {}
    for precision in ("fp32", "fp64"):
        model, st0, force = pack.build_packed_model(mesh, pre, cfg, mats,
                                                    device="cpu")
        stepper = NewmarkStepper(model, st0, force, ray, cfg.solver, cfg.time,
                                 vector_precision=precision)
        for frame in range(2):
            assert stepper.step(frame * stepper.current_dt).pcg_converged
        results[precision] = stepper.displacement().reshape(-1)

    assembly = oracle.assemble_linear_system(mesh, pre, mats)
    dirichlet = oracle.build_dirichlet_conditions(mesh, cfg)
    state = newmark.State.zeros(mesh.dof_count)
    model, _, force = pack.build_packed_model(mesh, pre, cfg, mats, device="cpu")
    load = model.to_nodal(force).numpy().reshape(-1).astype(np.float64)
    for frame in range(2):
        coeffs = newmark.make_coefficients(cfg.time.initial_dt)
        dense = oracle.solve_newmark_step(
            assembly, ray, dirichlet, mesh, cfg, pre, coeffs, state,
            frame * cfg.time.initial_dt, 1.0e-14, 8000, external_load=load,
        )
        state = dense.state

    u_ref = state.displacement
    scale = np.abs(u_ref).max()
    err64 = np.abs(results["fp64"] - u_ref).max() / scale
    err32 = np.abs(results["fp32"] - u_ref).max() / scale
    assert err64 < 1.0e-6, f"fp64-vector reproduction {err64:.2e} > 1e-6"
    assert err32 < 1.0e-3
    assert err64 < err32


# --------------------------------------------------------------------------
# the f64 sweep's geometry and taps (ops/cuda/plane_sweep.py against
# csrc/structured.cuh)


def _cuh_constants():
    """The sweep constants of csrc/structured.cuh, as the C compiler sees
    them (the ones smem_bytes reads)."""
    with open(os.path.join(REPO, "civiwave_tpu_torch", "csrc", "structured.cuh"),
              encoding="utf-8") as f:
        text = f.read()
    consts = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", text, re.M):
        consts[name] = eval(expr, {}, dict(consts))  # names defined above
    return consts


def _c_smem_bytes(vectors, elem):
    c = _cuh_constants()
    return (elem * (c["kStages"] * 3 * vectors * c["kStagePlane"] + 3 * c["kPlane"])
            + c["kStages"] * 3 * c["kHaloY"] * c["kMaskRow"])


@pytest.mark.parametrize("vectors, elem", [(1, 4), (1, 8), (3, 4)])
def test_sweep_shared_memory_matches_the_c_formula(vectors, elem):
    geom = plane_sweep.sweep_geometry((256, 256, 256), vectors, elem=elem)
    assert geom.smem_bytes == _c_smem_bytes(vectors, elem)
    assert geom.smem_bytes <= plane_sweep.SMEM_LIMIT
    if (vectors, elem) == (1, 8):
        # the f64 ring: twice the staged and transformed bytes, same mask
        assert geom.smem_bytes == 40_560
        f32 = plane_sweep.sweep_geometry((256, 256, 256), 1)
        assert (geom.tile, geom.chunk, geom.grid) == (f32.tile, f32.chunk, f32.grid)
    with pytest.raises(ValueError):
        plane_sweep.sweep_geometry((4, 4, 4), 1, elem=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vector_copies_rule(dtype):
    """16-byte copies where Z % 4 == 0 and every tensor is 16-byte aligned,
    for f64 as for f32 (the staged mask words need Z % 4 == 0)."""
    base = torch.zeros(4 * 8 * 64 + 8, dtype=dtype)
    aligned = base[: 4 * 8 * 64]
    assert aligned.data_ptr() % 16 == 0
    off = base[1: 1 + 4 * 8 * 64]  # 4 or 8 bytes past a 16-byte boundary
    assert plane_sweep.vector_copies(64, aligned) == 1
    assert plane_sweep.vector_copies(62, aligned) == 0
    assert plane_sweep.vector_copies(41, aligned) == 0
    assert plane_sweep.vector_copies(64, aligned, off) == 0


def test_sweep_taps64_give_the_class_table():
    """The f64 taps: the f32 factored interior coefficients widened, and
    z-face ghost taps with interior - ghost equal to the f32 class-table
    rows exactly (the f32 ghost taps miss them by a rounding)."""
    cfg = synthetic.cantilever_config()
    mat = cfg.materials[0]
    from civiwave_tpu_torch.mesh.structured import build_structured_model

    model, _ = build_structured_model(5, 4, 6, materials.make_properties(mat),
                                      mat.density, spacing=(0.3, 0.7, 1.1),
                                      device="cpu")
    from civiwave_tpu_torch.ops.structured import (
        _class_stencil_table64,
        expand_factored,
    )

    t64 = plane_sweep.sweep_taps64(model)
    t32 = plane_sweep.sweep_taps32(model)
    n = plane_sweep.FACTORED_TAPS
    assert t64.dtype == np.float64 and t64.shape == (plane_sweep.SWEEP_TAPS,)
    np.testing.assert_array_equal(t64[:n], t32[:n].astype(np.float64))
    table = model.stencil_table.numpy().reshape(27, 3, 3, 3, 3, 3)
    interior = expand_factored(t64[:n])[:, :, 1]
    ghost = t64[n:].reshape(2, 3, 3, 3, 3)
    for side, cls in ((0, 12), (1, 14)):
        np.testing.assert_array_equal(interior - ghost[side],
                                      table[cls][:, :, 1].astype(np.float64))
    # the f32 ghost taps are the f32-rounded differences from the f64 rows
    table64 = _class_stencil_table64(
        tuple(float(h) for h in model.spacing), float(model.lam0),
        float(model.mu0)).reshape(27, 3, 3, 3, 3, 3)
    want = np.stack([interior - table64[12][:, :, 1],
                     interior - table64[14][:, :, 1]])
    np.testing.assert_array_equal(want.reshape(-1).astype(np.float32), t32[n:])


def test_mass_correction_delta_is_exact_in_f64():
    """A multigrid coarse level's correction is exact in f64, and its f32
    rounding is what the f32 operator adds; f64 vectors take it in f64."""
    from civiwave_tpu_torch.ops import multigrid as tmg
    from civiwave_tpu_torch.mesh.structured import build_structured_model

    mat = synthetic.cantilever_config().materials[0]
    model, _ = build_structured_model(15, 7, 7, materials.make_properties(mat),
                                      mat.density, device="cpu")
    lvl = tmg.attach_multigrid(model).mg_levels[0]
    corr = lvl.mass_correction
    assert corr.delta.dtype == torch.float64
    synth = tops.synthesized_mass(lvl).reshape(-1)[corr.index].double()
    stored = lvl.mass_grid.reshape(-1)[corr.index].double()
    assert torch.equal(synth + corr.delta, stored)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(lvl.vector_shape))
    out = torch.zeros_like(x)
    fixed = tops.correct_synthesized_mass(lvl, out.clone(), x, 4000363.6000000001)
    assert fixed.dtype == torch.float64
    free = ~lvl.bc_mask.reshape(3, -1)[:, corr.index]
    want = (corr.delta * 4000363.6000000001)[None] * x.reshape(3, -1)[:, corr.index]
    assert torch.equal(fixed.reshape(3, -1)[:, corr.index][free], want[free])
