"""The CUDA kernels against their plain PyTorch versions, on the card: K1-K3
and K6 (the whole PCG iteration) of the structured route, K5 (the shard
operator, with K3's global offsets) of its sharded form, K4 (interior
stencil) and G2 (boundary corrections and envelope) of its slender route,
K7 (element forces, tet and hex) and G1 (CSR assembly) of the general
gather path; K1-K3 at the static mass factor 0, static solves on the card
against the CPU, the general path's dashpot term after G1; K1 with the
mass correction on multigrid coarse levels, and the V-cycle, multigrid
and pipelined solves on the card against the CPU; the f64 instances of
K1/K5, K3, K7 and G1 (``precision.vectors: fp64``) against their plain
versions in f64 at 1e-12 of max|ref|, and an fp64 simulation that
launches only them; G3 (the heterogeneous grid's corner gather, f32 and
f64) against its plain version on odd, padded and dead-row grids and on
grids that cut its tiles and chunks (``chip_smoke.G3_SHAPES``), on
uniform grids against K1 (3e-6 of max), the constant-stencil kernels
refusing a heterogeneous grid, and a heterogeneous cantilever on the
card against the CPU; G3 on the slabs and tiles of a heterogeneous grid
(its plane range, ghost planes, rows and cells) against its plain shard
version and, gathered, against the whole-grid G3, and a heterogeneous
cantilever on one-rank shards; G3 on a grid of per-cell densities and a
box_regions scenario stepped on G3 through build_simulation.  The fused loop's direction update
against its plain version bit for bit (f32 and f64, first and later calls,
random masks, lengths that are not a multiple of 4 or below 4; buffers
off a 16-byte boundary refused), and a fused solve with it against the
solve with the plain update.  The stepper's three vector passes against
their plain versions bit for bit (f32 and f64, grids of planes of 4 k
nodes and of an odd count, node rows, every set of added terms, views at
any offset), and
frames of a small cantilever with them against the frames with the plain
passes, three launches a frame.

Marked ``cuda``: each test skips where no CUDA device is present (the
kernels are compiled with nvcc for sm_90a at first use and cannot run
elsewhere).  This file imports no jax, so it also runs on a GPU machine
without it:

    python3 -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances: operator and preconditioner outputs at 1e-5 * max|ref|, dots
at rtol 1e-5 (the sums run in another order than the plain version's).
Bit for bit (``torch.equal``): the operator sweep K1/K5 on every slab or
tile cut against the whole grid, G3's cuts against the whole-grid G3 (f32
and f64), the overlap split against one launch, K2's
w against K1 of K2's u, G1 against its plain version, and G2's constrained
outputs against x.  K4 and G2 run on ``SLENDER_SHAPES``: the grids above
plus a column-shaped one (40 x 48 x 48 nodes, K4's 16 x 16 tiles), with
K4 at every tile and several chunks.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from chip_smoke import G3_SHAPES
from civiwave_tpu_torch.mesh import pack, preprocess
from civiwave_tpu_torch.mesh.structured import build_structured_model
from civiwave_tpu_torch.ops import apply_keff as gops
from civiwave_tpu_torch.ops import structured as tops
from civiwave_tpu_torch.ops.cuda import assemble_csr as g1
from civiwave_tpu_torch.ops.cuda import block_jacobi_apply as k3
from civiwave_tpu_torch.ops.cuda import element_forces as k7
from civiwave_tpu_torch.ops.cuda import interior_stencil as k4
from civiwave_tpu_torch.ops.cuda import newmark_vectors as nv
from civiwave_tpu_torch.ops.cuda import keff_boundary as g2
from civiwave_tpu_torch.ops.cuda import pcg_iteration as k6
from civiwave_tpu_torch.ops.cuda import pcg_vector_update as cgu
from civiwave_tpu_torch.ops.cuda import plane_sweep
from civiwave_tpu_torch.ops.cuda import structured_stencil as k12
from civiwave_tpu_torch.physics import materials
from civiwave_tpu_torch.runner import build_simulation
from civiwave_tpu_torch.solver import pcg as tpcg
from civiwave_tpu_torch.solver import stepper as tstepper
from civiwave_tpu_torch.utils.synthetic import (
    box_mesh,
    cantilever_config,
    shuffle_mesh_nodes,
    soil_column_config,
    split_last_hex,
)

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

OP_TOL, DOT_RTOL = 1e-5, 1e-5
SS, MF = np.float32(1.0000727), np.float32(4.0003636e6)

SHAPES = {
    "fixes_x0_z1": ((5, 4, 3), dict(fixed_axis_planes=("x0", "z1"))),
    "nx1": ((1, 3, 2), {}),
    "xpad4": ((6, 5, 4), dict(pad_x_multiple=4)),
    "odd_partial_fixes": ((17, 9, 33), dict(fixes=[
        ("x0", (True, True, True), (None, None, None)),
        ("y1", (False, True, False), (None, None, None)),
        ("z0", (True, False, True), (1e-3, None, None)),
    ])),
    "z_longer_than_a_block": ((2, 3, 300), {}),
}
# K1/K5, K2 and K6 sweep tiles of 8 x 32 (y, z) columns over chunks of 32 X
# planes (ops/cuda/plane_sweep.py): grids whose tiles meet the edges
SWEEP_SHAPES = {
    **SHAPES,
    # Y and Z ragged against the tile, Z % 4 != 0 (4-byte copies)
    "ragged_yz": ((5, 10, 40), {}),
    # X over two chunks, Z % 4 == 0 (16-byte copies)
    "x_over_two_chunks": ((69, 5, 7), {}),
    # X = 65 nodes: the last chunk holds one plane, which the chunk before
    # also sweeps (it must not emit it)
    "x_last_chunk_one_plane": ((64, 5, 7), {}),
    # two z tiles, 16-byte copies, Y ragged, X in two chunks
    "two_z_tiles": ((40, 17, 63), dict(fixed_axis_planes=("x0", "y0"))),
    # a face in every direction, ragged along all three axes
    "partial_fixes_33x19x45": ((33, 19, 45), dict(fixes=[
        ("x0", (True, True, True), (None, None, None)),
        ("y1", (False, True, False), (None, None, None)),
        ("z0", (True, False, True), (1e-3, None, None)),
    ])),
    "z2": ((4, 3, 1), {}),
}


# the slender route's kernels K4 and G2: the grids of SHAPES (Z % 4 != 0,
# +X pad planes, an n = 1 axis) and column-shaped and thin ones
SLENDER_SHAPES = {
    **SHAPES,
    "column_40x48x48": ((39, 47, 47), dict(fixed_axis_planes=())),
    "column_partial_fixes": ((39, 47, 47), dict(fixes=[
        ("x0", (True, True, True), (None, None, None)),
        ("y1", (False, True, False), (None, None, None)),
        ("z0", (True, False, True), (1e-3, None, None)),
    ])),
    "ny1_nz1": ((3, 1, 1), dict(fixed_axis_planes=("x0", "x1"))),
    "ypad4": ((5, 5, 3), dict(pad_y_multiple=4)),
}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda", 0)


def _model(device, case):
    dims, kw = {**SWEEP_SHAPES, **SLENDER_SHAPES}[case]
    mat = cantilever_config().materials[0]
    model, _ = build_structured_model(
        *dims, materials.make_properties(mat), mat.density, device=device, **kw
    )
    x = torch.as_tensor(
        np.random.default_rng(3).standard_normal(model.vector_shape, dtype=np.float32),
        device=device,
    )
    return model, x


def _close(out, ref):
    err = float((out - ref).abs().max())
    assert err <= OP_TOL * float(ref.abs().max()) + 1e-30


@pytest.mark.parametrize("case", sorted(SWEEP_SHAPES))
def test_keff_kernel_matches_plain(device, case):
    model, x = _model(device, case)
    before = k12.apply_keff_fused.launches
    out = k12.apply_keff_fused(model, x, SS, MF)
    torch.cuda.synchronize()
    assert k12.apply_keff_fused.launches == before + 1
    _close(out, k12.apply_keff_fused_plain(model, x, SS, MF))
    bc = model.bc_mask
    assert torch.equal(out[bc], x[bc])


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_block_jacobi_kernel_matches_plain(device, case):
    model, x = _model(device, case)
    pc = model.build_preconditioner(SS, MF)
    before = k3.apply_block_jacobi.launches
    z = k3.apply_block_jacobi(model, pc.table, x)
    torch.cuda.synchronize()
    assert k3.apply_block_jacobi.launches == before + 1
    _close(z, k3.apply_block_jacobi_plain(model, pc.table, x))
    zb = z[model.bc_mask]
    assert not zb.any() and not torch.signbit(zb).any()


@pytest.mark.parametrize("case", sorted(SWEEP_SHAPES))
def test_pc_keff_kernel_matches_plain(device, case):
    model, x = _model(device, case)
    pc = model.build_preconditioner(SS, MF)
    u, w, dots = k12.apply_pc_keff_fused(model, pc.table, x, SS, MF, with_dots=True)
    u2, w2 = k12.apply_pc_keff_fused(model, pc.table, x, SS, MF)
    torch.cuda.synchronize()
    u_ref, w_ref, dots_ref = k12.apply_pc_keff_fused_plain(
        model, pc.table, x, SS, MF, with_dots=True
    )
    for out in (u, u2):
        _close(out, u_ref)
    for out in (w, w2):
        _close(out, w_ref)
    for ours, ref in zip(dots, dots_ref):
        assert ours.dtype == torch.float64
        assert float(ours) == pytest.approx(float(ref), rel=DOT_RTOL)


@pytest.mark.parametrize("beta", [0.2, 0.0], ids=["beta", "beta0"])
@pytest.mark.parametrize("case", sorted(SWEEP_SHAPES))
def test_pcg_iteration_kernel_matches_plain(device, case, beta):
    model, _ = _model(device, case)
    pc = model.build_preconditioner(SS, MF)
    rng = np.random.default_rng(8)
    carries = tuple(
        torch.as_tensor(
            rng.standard_normal(model.vector_shape, dtype=np.float32), device=device
        )
        for _ in range(6)
    )
    alpha = torch.tensor(0.3, dtype=torch.float64, device=device)
    refs, ref_dots = k6.pcg_iteration_fused_plain(
        model, pc.table, carries, alpha.float(), beta, SS, MF
    )
    mine = tuple(c.clone() for c in carries)
    before = k6.pcg_iteration_fused.launches
    outs, dots = k6.pcg_iteration_fused(model, pc.table, mine, alpha, beta, SS, MF)
    torch.cuda.synchronize()
    assert k6.pcg_iteration_fused.launches == before + 1
    for out, ref in zip(outs, refs):
        _close(out, ref)
    # x, u and p are updated in place; r, w and s come back in new buffers
    for i in (0, 2, 4):
        assert outs[i] is mine[i]
    for i in (1, 3, 5):
        assert outs[i] is not mine[i] and torch.equal(mine[i], carries[i])
    for ours, ref in zip(dots, ref_dots):
        assert ours.dtype == torch.float64
        assert float(ours) == pytest.approx(float(ref), rel=DOT_RTOL)
    with pytest.raises(TypeError):
        k6.pcg_iteration_fused(
            model, pc.table, tuple(c.double() for c in carries), alpha, beta,
            SS, MF,
        )


@pytest.mark.parametrize("case", sorted(SWEEP_SHAPES))
def test_pc_keff_w_is_k1_of_its_u(device, case):
    """K2 and K1 are one sweep: K2's w equals K1 applied to K2's u, bit for
    bit."""
    model, x = _model(device, case)
    pc = model.build_preconditioner(SS, MF)
    u, w = k12.apply_pc_keff_fused(model, pc.table, x, SS, MF)
    assert torch.equal(w, k12.apply_keff_fused(model, u, SS, MF))


def test_wrappers_refuse_wrong_dtype_and_layout(device):
    model, x = _model(device, "xpad4")
    with pytest.raises(TypeError):  # f32 and f64 instances only
        k12.apply_keff_fused(model, x.half(), SS, MF)
    with pytest.raises(TypeError):  # K2 is f32 only, as the reference's
        k12.apply_pc_keff_fused(model, model.build_preconditioner(SS, MF).table,
                                x.double(), SS, MF)
    with pytest.raises(ValueError):
        k3.apply_block_jacobi(
            model, torch.zeros(6, 3, 3, 3, device=device), x.transpose(2, 3)
        )


def test_small_cantilever_runs_fused_on_the_card(device):
    """'auto' takes the fused loop on CUDA, and the trajectory matches the
    CPU run of the plain versions (iterations +-1, dt identical)."""
    cfg = cantilever_config(tol_runtime=2e-4, max_iters=120,
                            mesh={"path": "synthetic://box/12,6,6"})
    runs = {}
    for dev in (device, "cpu"):
        sim = build_simulation(cfg, device=dev)
        before = k12.apply_pc_keff_fused.launches
        tel = sim.run(4)
        runs[str(dev)] = (tel, sim.stepper.state.displacement.cpu(),
                          k12.apply_pc_keff_fused.launches - before)
    (tg, ug, n_gpu), (tc, uc, n_cpu) = runs[str(device)], runs["cpu"]
    assert n_gpu > 0 and n_cpu == 0
    assert all(t.pcg_converged for t in tg)
    assert all(abs(a.pcg_iterations - b.pcg_iterations) <= 1 for a, b in zip(tg, tc))
    np.testing.assert_allclose(
        ug.numpy(), uc.numpy(), rtol=0, atol=2.5e-4 * float(uc.abs().max())
    )


def test_small_cantilever_runs_megafused_on_the_card(device, monkeypatch):
    """With CIVIWAVE_MEGA_PCG=1 the fused variant runs one K6 launch per
    PCG iteration on CUDA; the trajectory matches the CPU run of the plain
    K6 (iterations +-1, u at 2.5e-4 of max|ref|)."""
    monkeypatch.setenv("CIVIWAVE_MEGA_PCG", "1")
    cfg = cantilever_config(tol_runtime=2e-4, max_iters=120,
                            mesh={"path": "synthetic://box/12,6,6"})
    runs = {}
    for dev in (device, "cpu"):
        sim = build_simulation(cfg, device=dev)
        sim.stepper.solver_variant = "fused"
        before = (k6.pcg_iteration_fused.launches, k12.apply_pc_keff_fused.launches)
        tel = sim.run(4)
        runs[str(dev)] = (tel, sim.stepper.state.displacement.cpu(),
                          k6.pcg_iteration_fused.launches - before[0],
                          k12.apply_pc_keff_fused.launches - before[1])
    (tg, ug, n6, n2), (tc, uc, n6_cpu, _) = runs[str(device)], runs["cpu"]
    assert n6 == sum(t.pcg_iterations for t in tg) and n6_cpu == 0
    assert n2 == 4  # K2 only in each solve's setup
    assert all(t.pcg_converged for t in tg)
    assert all(abs(a.pcg_iterations - b.pcg_iterations) <= 1 for a, b in zip(tg, tc))
    np.testing.assert_allclose(
        ug.numpy(), uc.numpy(), rtol=0, atol=2.5e-4 * float(uc.abs().max())
    )


# the direction update's layouts: a structured (3, X, Y, Z) vector (length
# a multiple of 4, four blocks), general (N, 3) rows of odd N (a scalar
# tail) and a single row (the tail alone)
UPDATE_LAYOUTS = {"structured": (3, 9, 10, 12), "rows_37": (37, 3),
                  "rows_1": (1, 3)}


def _update_inputs(device, layout, dtype, seed=11):
    shape = UPDATE_LAYOUTS[layout]
    g = torch.Generator().manual_seed(seed)

    def vec():
        return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype).to(device)

    bc = (torch.rand(shape, generator=g) < 0.3).to(device)
    x, r, p, s, u, w = (vec() for _ in range(6))
    u[bc] = float("nan")  # a select writes +0.0 there whatever u holds
    return bc, x, r, p, s, u, w


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("call", ["first", "later", "beta0", "f32_scalars"])
@pytest.mark.parametrize("layout", sorted(UPDATE_LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_direction_update_kernel_matches_plain(device, dtype, layout, call):
    """The kernel writes x, r, p and s in place with the plain version's
    bits (+0.0 on constrained components), from 0-d device scalars."""
    bc, x, r, p, s, u, w = _update_inputs(device, layout, dtype)
    sdt = torch.float32 if call == "f32_scalars" else torch.float64
    alpha = torch.tensor(0.37134791250387, dtype=sdt, device=device)
    beta = {"first": None, "beta0": torch.zeros((), dtype=sdt, device=device)}.get(
        call, torch.tensor(-0.61927358129, dtype=sdt, device=device))
    ref = cgu.cg_direction_update_plain(bc, x, r, p, s, u, w, alpha, beta, dtype)
    xk, rk, pk, sk = x.clone(), r.clone(), p.clone(), s.clone()
    counter = "launches" if dtype == torch.float32 else "launches_f64"
    before = getattr(cgu.cg_direction_update, counter)
    out = cgu.cg_direction_update(bc, xk, rk, pk, sk, u, w, alpha, beta, dtype)
    torch.cuda.synchronize()
    assert getattr(cgu.cg_direction_update, counter) == before + 1
    assert out[0] is xk and out[1] is rk
    if call != "first":
        assert out[2] is pk and out[3] is sk
    for got, want in zip(out, ref):
        assert torch.equal(_bits(got), _bits(want))
    assert not _bits(out[2])[bc].any() and not _bits(out[3])[bc].any()


def test_direction_update_refuses_wrong_inputs(device):
    bc, x, r, p, s, u, w = _update_inputs(device, "structured", torch.float32)
    alpha = beta = torch.tensor(0.5, dtype=torch.float64, device=device)
    args = dict(bc=bc, x=x, r=r, p=p, s=s, u=u, w=w, alpha=alpha, beta=beta,
                dtype=torch.float32)
    for key, bad, error in (
            ("x", x.transpose(1, 2), ValueError),  # not contiguous
            ("u", u.double(), TypeError),  # mixed dtypes
            ("w", w[:, :, :, :4].contiguous(), ValueError),  # shape
            ("s", s.reshape(-1), ValueError),
            ("bc", bc.to(torch.uint8), TypeError),
            ("beta", beta.float(), TypeError),  # alpha's dtype
            ("alpha", alpha.cpu(), ValueError),
            # one value off a 16-byte boundary; the mask off a 4-byte one
            ("x", torch.empty(x.numel() + 1, device=device)[1:].view(x.shape),
             ValueError),
            ("bc", torch.zeros(bc.numel() + 1, dtype=torch.bool,
                               device=device)[1:].view(bc.shape), ValueError)):
        with pytest.raises(error):
            cgu.cg_direction_update(**{**args, key: bad})
    with pytest.raises(TypeError):  # f32 and f64 instances only
        cgu.cg_direction_update(**{**args, **{k: args[k].half() for k in "xrpsuw"},
                                   "dtype": torch.float16})


def test_fused_solve_with_the_update_kernel_matches_plain_update(device, monkeypatch):
    """A fused solve of the small cantilever on the card: one update launch
    per iteration, and the same x bit for bit and the same iterations as
    the solve whose update is the torch composition on the same tensors."""
    cfg = cantilever_config(tol_runtime=2e-4, max_iters=120,
                            mesh={"path": "synthetic://box/12,6,6"})
    model = build_simulation(cfg, device=device).model
    g = torch.Generator().manual_seed(4)
    rhs = (1e3 * torch.randn(model.vector_shape, generator=g)).to(device)
    x0 = (1e-6 * torch.randn(model.vector_shape, generator=g)).to(device)

    def solve():
        return tpcg.solve_pcg(model, rhs, SS, MF, 2e-4, 120, x0, variant="fused")

    before = cgu.cg_direction_update.launches
    x, tel = solve()
    torch.cuda.synchronize()
    launches = cgu.cg_direction_update.launches - before
    monkeypatch.setattr(tpcg, "cg_direction_update", cgu.cg_direction_update_plain)
    x_ref, tel_ref = solve()
    assert tel.converged and tel.iterations > 3
    assert launches == tel.iterations == tel_ref.iterations
    assert torch.equal(_bits(x), _bits(x_ref))
    for field in ("residual_norm", "alpha_last", "beta_last"):
        assert torch.equal(getattr(tel, field), getattr(tel_ref, field)), field


# the stepper's passes: a grid of planes of 4 k nodes, one of an odd
# count, node rows of N % 4 != 0 and a single row
NEWMARK_LAYOUTS = {"grid": (3, 8, 9, 12), "grid_odd": (3, 5, 9, 7),
                   "rows_37": (37, 3), "rows_1": (1, 3)}
NEWMARK_SCALARS = nv.NewmarkScalars(
    dt=1e-3, c_pred=0.25e-6, a0=4e6, a2=4e3, a3=1.0, a1=2e3, a4=1.0, a5=0.0,
    alpha_r=0.36363636363636365, beta_r=3.6363636363636364e-4, c_vpred=0.5e-3,
    c_v=2e3, c_a=4e6)


def _newmark_inputs(device, layout, dtype, seed=5):
    shape = NEWMARK_LAYOUTS[layout]
    g = torch.Generator().manual_seed(seed)

    def vec(scale):
        return (scale * torch.randn(shape, generator=g, dtype=torch.float64)
                ).to(dtype).to(device)

    u, v, a, f, x, kd, cd = (vec(s) for s in (1e-4, 1e-2, 10.0, 1e5, 1e-4, 1e7, 1e3))
    mass_shape = (1, *shape[1:]) if len(shape) == 4 else (shape[0], 1)
    mass = ((1.0 + torch.rand(mass_shape, generator=g)) * 7800.0).to(device)
    bc = (torch.rand(shape, generator=g) < 0.3).to(device)
    bc_value = (1e-3 * torch.randn(shape, generator=g)).to(device)
    return u, v, a, f, x, kd, cd, mass, bc, bc_value


def _newmark_launches():
    return {w.__name__: (w.launches, w.launches_f64) for w in (
        nv.newmark_rhs, nv.newmark_rhs_clamp, nv.newmark_update)}


@pytest.mark.parametrize("terms", ["kd", "kd_absorb", "absorb", "none"])
@pytest.mark.parametrize("layout", sorted(NEWMARK_LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_newmark_passes_match_plain(device, dtype, layout, terms):
    """Each pass gives its plain version's bits; the clamp writes rhs in
    place; delta is written under the "delta" policy only."""
    u, v, a, f, x, kd, cd, mass, bc, bc_value = _newmark_inputs(device, layout, dtype)
    k = NEWMARK_SCALARS
    kd = kd if "kd" in terms else None
    cd = cd if "absorb" in terms else None
    write_delta = terms in ("kd_absorb", "none")
    before = _newmark_launches()
    ref_a = nv.newmark_rhs_plain(mass, u, v, a, f, k)
    got_a = nv.newmark_rhs(mass, u, v, a, f, k)
    ref_b = nv.newmark_rhs_clamp_plain(ref_a[2], kd, cd, bc, bc_value, k)
    rhs = got_a[2]
    got_b = nv.newmark_rhs_clamp(rhs, kd, cd, bc, bc_value, k)
    ref_c = nv.newmark_update_plain(x, ref_a[0], v, a, k, write_delta)
    got_c = nv.newmark_update(x, got_a[0], v, a, k, write_delta)
    torch.cuda.synchronize()
    assert got_b is rhs
    # (got_a's rhs is the clamp's, written in place)
    for got, want in zip((*got_a[:2], got_b, *got_c[:3]),
                         (*ref_a[:2], ref_b, *ref_c[:3])):
        assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got_b[bc]), _bits(bc_value[bc].to(dtype)))
    if write_delta:
        assert torch.equal(_bits(got_c[3]), _bits(ref_c[3]))
    else:
        assert got_c[3] is None
    slot = 0 if dtype == torch.float32 else 1
    after = _newmark_launches()
    for name, counts in after.items():
        assert counts[slot] == before[name][slot] + 1, name
        assert counts[1 - slot] == before[name][1 - slot], name


def test_newmark_passes_refuse_wrong_inputs(device):
    u, v, a, f, x, kd, cd, mass, bc, bc_value = _newmark_inputs(
        device, "grid", torch.float32)
    k = NEWMARK_SCALARS
    strided = torch.empty((*u.shape[:-1], 2 * u.shape[-1]), device=device)[..., ::2]
    for call, error in (
            (lambda: nv.newmark_rhs(mass.reshape(-1), u, v, a, f, k), ValueError),
            (lambda: nv.newmark_rhs(mass, strided, v, a, f, k), ValueError),
            (lambda: nv.newmark_rhs(mass, u, v.double(), a, f, k), TypeError),
            (lambda: nv.newmark_rhs(mass, u, v, a, f.cpu(), k), ValueError),
            (lambda: nv.newmark_rhs_clamp(f, kd, None, bc, bc_value.double(), k),
             TypeError),
            (lambda: nv.newmark_update(x, strided, v, a, k), ValueError)):
        with pytest.raises(error):
            call()


def _newmark_off16(t):
    """``t``'s values in a view that starts one value past a 16-byte
    boundary."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("layout", sorted(NEWMARK_LAYOUTS))
def test_newmark_passes_take_views_at_any_offset(device, layout):
    """The kernels read and write single values: views off a 16-byte
    boundary give the plain versions' bits."""
    u, v, a, f, x, kd, cd, mass, bc, bc_value = _newmark_inputs(
        device, layout, torch.float32)
    k = NEWMARK_SCALARS
    off = _newmark_off16
    ref_a = nv.newmark_rhs_plain(mass, u, v, a, f, k)
    got_a = nv.newmark_rhs(off(mass), off(u), v, off(a), f, k)
    ref_b = nv.newmark_rhs_clamp_plain(ref_a[2], kd, cd, bc, bc_value, k)
    got_b = nv.newmark_rhs_clamp(off(got_a[2]), off(kd), cd, off(bc), off(bc_value), k)
    ref_c = nv.newmark_update_plain(x, ref_a[0], v, a, k, True)
    got_c = nv.newmark_update(off(x), got_a[0], off(v), a, k, True)
    torch.cuda.synchronize()
    for got, want in zip((*got_a[:2], got_b, *got_c), (*ref_a[:2], ref_b, *ref_c)):
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("precision,policy", [("fp32", "predictor"), ("fp64", "delta")])
def test_newmark_step_with_the_passes_matches_plain_passes(device, monkeypatch,
                                                          precision, policy):
    """Frames of a small cantilever (Rayleigh beta_R > 0) with the three
    passes: three launches a frame, and the state bits and iterations of
    the same frames with the plain passes on the same card."""
    cfg = cantilever_config(tol_runtime=2e-4, max_iters=120,
                            mesh={"path": "synthetic://box/12,6,6"})
    frames = 4

    def run():
        sim = build_simulation(cfg, device=device)
        sim.stepper.vector_precision = precision
        sim.stepper.warm_start_policy = policy
        tel = sim.run(frames)
        torch.cuda.synchronize()
        return sim.stepper.state, [t.pcg_iterations for t in tel]

    assert materials.compute_rayleigh(cfg.damping).beta > 0.0
    before = _newmark_launches()
    state, iters = run()
    after = _newmark_launches()
    slot = 0 if precision == "fp32" else 1
    assert sum(after[n][slot] - before[n][slot] for n in after) == 3 * frames
    for name in after:
        assert after[name][slot] - before[name][slot] == frames, name
    for name, plain in (("newmark_rhs", nv.newmark_rhs_plain),
                        ("newmark_rhs_clamp", nv.newmark_rhs_clamp_plain),
                        ("newmark_update", nv.newmark_update_plain)):
        monkeypatch.setattr(tstepper, name, plain)
    ref, ref_iters = run()
    assert iters == ref_iters and all(n > 0 for n in iters)
    for field in dataclasses.fields(state):
        assert torch.equal(_bits(getattr(state, field.name)),
                           _bits(getattr(ref, field.name))), field.name


# --- slender route: K4 and G2 --------------------------------------------


@pytest.mark.parametrize("case", sorted(SLENDER_SHAPES))
def test_interior_stencil_kernel_matches_plain(device, case):
    model, x = _model(device, case)
    xs = x.masked_fill(model.bc_mask, 0.0)
    taps = tops.interior_taps(model)
    before = k4.interior_stencil.launches
    out = k4.interior_stencil(xs, taps)
    torch.cuda.synchronize()
    assert k4.interior_stencil.launches == before + 1
    _close(out, k4.interior_stencil_plain(xs, taps))


@pytest.mark.parametrize("case", sorted(SLENDER_SHAPES))
def test_keff_boundary_kernel_matches_plain(device, case):
    model, x = _model(device, case)
    interior = k4.interior_stencil_plain(
        x.masked_fill(model.bc_mask, 0.0), tops.interior_taps(model)
    )
    before = g2.keff_boundary.launches
    out = g2.keff_boundary(model, interior, x, SS, MF)
    torch.cuda.synchronize()
    assert g2.keff_boundary.launches == before + 1
    _close(out, g2.keff_boundary_plain(model, interior, x, SS, MF))
    bc = model.bc_mask
    assert torch.equal(out[bc], x[bc])


@pytest.mark.parametrize("case", sorted(SLENDER_SHAPES))
def test_split_route_matches_k1(device, case):
    model, x = _model(device, case)
    _close(tops.apply_keff_split_structured(model, x, SS, MF),
           k12.apply_keff_fused(model, x, SS, MF))


@pytest.mark.parametrize("case", ["column_40x48x48", "z_longer_than_a_block",
                                  "xpad4", "nx1"])
def test_interior_stencil_every_geometry(device, case):
    """K4 with each tile it is built for and chunks from one plane to more
    than the grid, both staging paths (16-byte copies on the column, 4-byte
    ones at Z = 301 and on a misaligned view)."""
    model, x = _model(device, case)
    xs = x.masked_fill(model.bc_mask, 0.0)
    taps = tops.interior_taps(model)
    ref = k4.interior_stencil_plain(xs, taps)
    buf = torch.zeros(xs.numel() + 1, device=device)
    shifted = buf[1:].view(xs.shape)
    shifted.copy_(xs)
    for tile in plane_sweep.STENCIL_TILES:
        for chunk in (1, 3, 16, 32, 2048):
            geom = plane_sweep.stencil_geometry(model.grid_shape, tile, chunk)
            for v in (xs, shifted):
                _close(k4.launch(v, taps, geom), ref)
    torch.cuda.synchronize()


def test_keff_boundary_scalar_envelope(device):
    """G2 on a misaligned x (a view one float in): the one-node envelope,
    the same outputs as the float4 one."""
    model, x = _model(device, "column_partial_fixes")
    interior = k4.interior_stencil_plain(
        x.masked_fill(model.bc_mask, 0.0), tops.interior_taps(model))
    buf = torch.zeros(x.numel() + 1, device=device)
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    ref = g2.keff_boundary_plain(model, interior, x, SS, MF)
    for v in (x, shifted):
        out = g2.keff_boundary(model, interior, v, SS, MF)
        torch.cuda.synchronize()
        _close(out, ref)
        assert torch.equal(out[model.bc_mask], x[model.bc_mask])


def test_slender_wrappers_refuse_wrong_dtype_and_layout(device):
    model, x = _model(device, "xpad4")
    taps = tops.interior_taps(model)
    with pytest.raises(TypeError):
        k4.interior_stencil(x.double(), taps)
    with pytest.raises(ValueError):
        k4.interior_stencil(x[0], taps)
    with pytest.raises(ValueError):
        g2.keff_boundary(model, x.transpose(2, 3), x, SS, MF)


def test_small_soil_column_runs_split_on_the_card(device, monkeypatch):
    """The soil column on the forced slender route: K4 and G2 once per
    matvec (classic PCG: each frame's Rayleigh and residual matvecs plus
    one per iteration), K1 and K2 never; the trajectory matches the CPU run
    of the plain versions (iterations +-1, u at 2.5e-4 of max|ref|)."""
    monkeypatch.setattr(tops, "_FLAT_INTERIOR_NODE_THRESHOLD", 0)
    cfg = soil_column_config(cells=(40, 5, 5))
    runs = {}
    for dev in (device, "cpu"):
        sim = build_simulation(cfg, device=dev)
        wrappers = (k4.interior_stencil, g2.keff_boundary,
                    k12.apply_keff_fused, k12.apply_pc_keff_fused)
        before = [w.launches for w in wrappers]
        tel = sim.run(6)
        runs[str(dev)] = (tel, sim.stepper.state.displacement.cpu(),
                          [w.launches - b for w, b in zip(wrappers, before)])
    (tg, ug, counts), (tc, uc, cpu_counts) = runs[str(device)], runs["cpu"]
    matvecs = sum(t.pcg_iterations for t in tg) + 2 * len(tg)
    assert counts == [matvecs, matvecs, 0, 0] and cpu_counts == [0, 0, 0, 0]
    assert all(t.pcg_converged for t in tg)
    assert all(abs(a.pcg_iterations - b.pcg_iterations) <= 1 for a, b in zip(tg, tc))
    np.testing.assert_allclose(
        ug.numpy(), uc.numpy(), rtol=0, atol=2.5e-4 * float(uc.abs().max())
    )


# --- general gather path: K7 and G1 --------------------------------------

GENERAL = {
    "tet_5x4x3": lambda: box_mesh(5, 4, 3),
    "hex_6x5x4": lambda: box_mesh(6, 5, 4, hex_elements=True),
    "mixed_4x4x4": lambda: split_last_hex(box_mesh(4, 4, 4, hex_elements=True)),
    "shuffled_hex_5x5x5": lambda: shuffle_mesh_nodes(
        box_mesh(5, 5, 5, hex_elements=True), seed=5
    ),
    "tet_12x6x6": lambda: box_mesh(12, 6, 6),  # 2592 tets: many thread blocks
}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _general(device, case):
    cfg = cantilever_config()
    mesh = GENERAL[case]()
    pre = preprocess.run(mesh, cfg)
    mats = [materials.make_properties(m) for m in cfg.materials]
    model, _, _ = pack.build_packed_model(mesh, pre, cfg, mats, device=device)
    x = torch.as_tensor(
        np.random.default_rng(4).standard_normal(model.vector_shape, dtype=np.float32),
        device=device,
    )
    return model, x


@pytest.mark.parametrize("case", sorted(GENERAL))
def test_element_forces_kernel_matches_plain(device, case):
    model, x = _general(device, case)
    for block, wrapper, count in (
        ("tet", k7.tet_element_forces, model.padded_tet_count),
        ("hex", k7.hex_element_forces, model.padded_hex_count),
    ):
        if not count:
            continue
        before = wrapper.launches
        rows = wrapper(model, x, SS)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        _close(rows, k7.element_forces_plain(model, x, SS, block))


@pytest.mark.parametrize("mf", [MF, np.float32(0.0)], ids=["mass", "no_mass"])
@pytest.mark.parametrize("case", sorted(GENERAL))
def test_assemble_kernel_matches_plain(device, case, mf):
    model, x = _general(device, case)
    rows = k7.element_force_rows(model, x, SS)
    before = g1.assemble_keff.launches
    out = g1.assemble_keff(model, rows, x, mf)
    torch.cuda.synchronize()
    assert g1.assemble_keff.launches == before + 1
    # node counts that are not a multiple of the block; D = 8 (hex) and 24
    assert torch.equal(out, g1.assemble_keff_plain(model, rows, x, mf))
    assert torch.equal(out[model.bc_mask], x[model.bc_mask])


def test_general_apply_keff_launches_k7_and_g1(device):
    model, x = _general(device, "mixed_4x4x4")
    counts = (k7.tet_element_forces.launches, k7.hex_element_forces.launches,
              g1.assemble_keff.launches)
    out = gops.apply_keff(model, x, SS, MF)
    torch.cuda.synchronize()
    assert (k7.tet_element_forces.launches, k7.hex_element_forces.launches,
            g1.assemble_keff.launches) == tuple(c + 1 for c in counts)
    _close(out, gops.apply_keff_plain(model, x, SS, MF))
    with pytest.raises(TypeError):  # f32 and f64 instances only
        gops.apply_keff(model, x.half(), SS, MF)


def test_seismic_column_runs_on_the_card(device):
    """The general path (tet Gmsh mesh, two materials, curve-scaled
    traction) on the card against the CPU run of the plain versions."""
    scenario = os.path.join(REPO, "examples", "seismic_column_tet.yaml")
    runs = {}
    for dev in (device, "cpu"):
        sim = build_simulation(scenario, device=dev)
        before = g1.assemble_keff.launches
        tel = sim.run(4)
        runs[str(dev)] = (tel, sim.stepper.displacement(),
                          g1.assemble_keff.launches - before)
    (tg, ug, n_gpu), (tc, uc, n_cpu) = runs[str(device)], runs["cpu"]
    assert n_gpu > 0 and n_cpu == 0
    assert all(t.pcg_converged for t in tg)
    assert all(abs(a.pcg_iterations - b.pcg_iterations) <= 1 for a, b in zip(tg, tc))
    np.testing.assert_allclose(ug, uc, rtol=0, atol=2.5e-4 * float(np.abs(uc).max()))


# --------------------------------------------------------------------------
# K5 (the shard operator) and K3 with global offsets
# --------------------------------------------------------------------------

# name -> (cells, (npx, npy), 2-D): the reference's sharded grids
HALO = {
    "1d_6x3x3_over_8": ((6, 3, 3), (8, 1), False),
    "1d_15x4x4_over_4": ((15, 4, 4), (4, 1), False),
    "2d_9x4x5_on_2x4": ((9, 4, 5), (2, 4), True),
    "2d_7x7x3_on_2x2": ((7, 7, 3), (2, 2), True),
    "1d_odd_z300_over_2": ((3, 3, 300), (2, 1), False),
    # one 70-plane slab: three X chunks, the split, 16-byte staging
    "1d_69x5x7_whole": ((69, 5, 7), (1, 1), False),
    # 2-D tiles of 21 x 9 nodes: two y tiles, the +Y ghost row inside the
    # second one's halo, two z tiles, 16-byte staging
    "2d_40x17x63_on_2x2": ((40, 17, 63), (2, 2), True),
}


def _halo_tiles(device, case):
    """(whole model, x, [(tile model with its mask ghosts, x block, x
    ghosts, (x0, y0, Xl, Yl))]) of one grid, cut without a process group."""
    from civiwave_tpu_torch.ops.structured_sharded import cut_ghosts
    from civiwave_tpu_torch.parallel import sharding

    cells, shape, two_d = HALO[case]
    mat = cantilever_config().materials[0]
    model, _ = build_structured_model(
        *cells, materials.make_properties(mat), mat.density, device=device,
        pad_x_multiple=shape[0], pad_y_multiple=shape[1] if two_d else 1,
    )
    x = torch.as_tensor(
        np.random.default_rng(5).standard_normal(model.vector_shape, dtype=np.float32),
        device=device,
    )
    tiles = []
    for local in sharding.local_tiles(model, shape, two_d):
        x0, y0, (xl, yl) = local.x0, local.y0, local.local_extent
        tiles.append((local, sharding.cut_block(x, x0, y0, xl, yl),
                      cut_ghosts(x, x0, y0, xl, yl, two_d), (x0, y0, xl, yl)))
    return model, x, tiles


@pytest.mark.parametrize("case", sorted(HALO))
def test_keff_halo_kernel_matches_plain_and_k1(device, case, monkeypatch):
    from civiwave_tpu_torch.ops.cuda import keff_halo as k5
    from civiwave_tpu_torch.ops.structured_sharded import local_keff

    model, x, tiles = _halo_tiles(device, case)
    gathered = torch.empty_like(x)
    for local, xt, ghosts, (x0, y0, xl, yl) in tiles:
        before = k5.keff_structured_halo.launches
        out = k5.keff_structured_halo(local, xt, ghosts, SS, MF)
        torch.cuda.synchronize()
        assert k5.keff_structured_halo.launches == before + 1
        _close(out, k5.keff_structured_halo_plain(local, xt, ghosts, SS, MF))
        if xl >= 4:  # the overlap split's three launches write the same bits
            monkeypatch.setenv("CIVIWAVE_HALO_OVERLAP", "1")
            before = k5.keff_structured_halo.launches
            assert torch.equal(local_keff(local, xt, ghosts, SS, MF), out)
            assert k5.keff_structured_halo.launches == before + 3
        gathered[:, x0:x0 + xl, y0:y0 + yl] = out
    assert torch.equal(gathered, k12.apply_keff_fused(model, x, SS, MF))


@pytest.mark.parametrize("case", sorted(HALO))
def test_keff_halo_missing_ghosts_read_as_zero(device, case):
    """A ghost buffer of None (values and mask) at a global end gives the
    bits of the zero ghost a group delivers there."""
    from civiwave_tpu_torch.ops.cuda import keff_halo as k5

    model, _, tiles = _halo_tiles(device, case)
    for local, xt, ghosts, (x0, y0, xl, yl) in tiles:
        ends = {"x_lo": x0 == 0, "x_hi": x0 + xl == model.grid_shape[0],
                "y_lo": y0 == 0, "y_hi": y0 + yl == model.grid_shape[1]}
        cut = {k: None for k, end in ends.items()
               if end and getattr(ghosts, k) is not None}
        if not cut:
            continue
        bare = dataclasses.replace(local, bc_ghosts=local.bc_ghosts._replace(**cut))
        assert torch.equal(
            k5.keff_structured_halo(bare, xt, ghosts._replace(**cut), SS, MF),
            k5.keff_structured_halo(local, xt, ghosts, SS, MF))


def test_keff_halo_on_one_shard_is_k1(device):
    """One shard, no ghosts: the launch K1 makes on the whole grid, bit for
    bit."""
    from civiwave_tpu_torch.ops.cuda import keff_halo as k5
    from civiwave_tpu_torch.ops.structured_sharded import Ghosts
    from civiwave_tpu_torch.parallel import sharding

    model, x = _model(device, "odd_partial_fixes")
    local = dataclasses.replace(
        sharding.local_model(model, (1, 1), (0, 0)), bc_ghosts=Ghosts(None, None))
    out = k5.keff_structured_halo(local, x, Ghosts(None, None), SS, MF)
    assert torch.equal(out, k12.apply_keff_fused(model, x, SS, MF))
    with pytest.raises(TypeError):  # f32 and f64 instances only
        k5.keff_structured_halo(local, x.half(), None, SS, MF)
    with pytest.raises(ValueError):
        k5.keff_structured_halo(local, x, None, SS, MF, planes=(0, 10**6))


@pytest.mark.parametrize("case", sorted(HALO))
def test_block_jacobi_kernel_with_offsets(device, case):
    model, x, tiles = _halo_tiles(device, case)
    pc = model.build_preconditioner(SS, MF)
    ref = k3.apply_block_jacobi(model, pc.table, x)
    gathered = torch.empty_like(x)
    for local, xt, _, (x0, y0, xl, yl) in tiles:
        z = k3.apply_block_jacobi(local, pc.table, xt)
        _close(z, k3.apply_block_jacobi_plain(local, pc.table, xt))
        gathered[:, x0:x0 + xl, y0:y0 + yl] = z
    torch.cuda.synchronize()
    assert torch.equal(gathered, ref)


def test_small_cantilever_runs_sharded_on_one_rank(device, monkeypatch):
    """A one-rank NCCL group: 'auto' is fused, every matvec is K5 (three
    launches with the overlap split), K1/K2/K6 never run, and the frames
    match the unsharded fused run on the card."""
    from civiwave_tpu_torch.ops.cuda import keff_halo as k5
    from civiwave_tpu_torch.parallel import collectives, sharding

    monkeypatch.delenv("CIVIWAVE_HALO_OVERLAP", raising=False)
    cfg = cantilever_config(tol_runtime=2e-4, max_iters=120,
                            mesh={"path": "synthetic://box/12,6,6"})
    ref = build_simulation(cfg, device=device)
    tel_ref = ref.run(4)
    try:
        sim = sharding.shard_simulation(build_simulation(cfg, device=device),
                                        sharding.make_shard_group(1, device))
        before = (k5.keff_structured_halo.launches, k12.apply_keff_fused.launches,
                  k12.apply_pc_keff_fused.launches)
        collectives.reset_counts()
        tel = sim.run(4)
        torch.cuda.synchronize()
    finally:
        sharding.close_shard_group()
    iters = [t.pcg_iterations for t in tel]
    matvecs = 3 * len(tel) + sum(iters)
    assert k5.keff_structured_halo.launches - before[0] == 3 * matvecs
    assert k12.apply_keff_fused.launches == before[1]
    assert k12.apply_pc_keff_fused.launches == before[2]
    assert collectives.psum.shapes[(torch.float64, (3,))] == sum(iters)
    assert all(abs(a - b.pcg_iterations) <= 1 for a, b in zip(iters, tel_ref))
    u, u_ref = sim.stepper.state.displacement, ref.stepper.state.displacement
    assert float((u - u_ref).abs().max()) <= 2.5e-4 * float(u_ref.abs().max())


# --- static mode (mass factor 0) and the general path's dashpot term --------

ONE, ZERO = np.float32(1.0), np.float32(0.0)


@pytest.mark.parametrize("case", sorted(SWEEP_SHAPES))
def test_keff_and_pc_keff_kernels_at_mass_factor_0(device, case):
    """The static operator (ss 1, mf 0): K1 and K2 against their plain
    versions with the stiffness-only class table; constrained rows stay
    identity rows and nothing is divided by the mass term."""
    model, x = _model(device, case)
    pc = model.build_preconditioner(ONE, ZERO)
    assert bool(torch.isfinite(pc.table).all())
    out = k12.apply_keff_fused(model, x, ONE, ZERO)
    _close(out, k12.apply_keff_fused_plain(model, x, ONE, ZERO))
    assert torch.equal(out[model.bc_mask], x[model.bc_mask])
    u, w, dots = k12.apply_pc_keff_fused(model, pc.table, x, ONE, ZERO, with_dots=True)
    u_ref, w_ref, dots_ref = k12.apply_pc_keff_fused_plain(
        model, pc.table, x, ONE, ZERO, with_dots=True)
    _close(u, u_ref)
    _close(w, w_ref)
    _close(k3.apply_block_jacobi(model, pc.table, x),
           k3.apply_block_jacobi_plain(model, pc.table, x))
    for ours, ref in zip(dots, dots_ref):
        assert float(ours) == pytest.approx(float(ref), rel=DOT_RTOL)


@pytest.mark.parametrize("variant", ["auto", "classic", "mega"])
def test_static_solve_16_cubed_matches_the_cpu(device, variant, monkeypatch):
    """solve_static on the 16^3 steel cantilever on the card ('auto' =
    fused with K2, classic with K1 and K3, the K6 loop) against the CPU's
    classic solve: converged, u within 2.5e-4 of max|u|."""
    from civiwave_tpu_torch.solver.static import solve_static

    mat = cantilever_config().materials[0]
    runs = {}
    for dev in (device, "cpu"):
        model, force = build_structured_model(
            16, 16, 16, materials.make_properties(mat), mat.density,
            traction=(0.0, 0.0, -1.0e6), device=dev)
        on_card = dev != "cpu"
        if on_card and variant == "mega":
            monkeypatch.setenv("CIVIWAVE_MEGA_PCG", "1")
        chosen = ("fused" if variant == "mega" else variant) if on_card else "classic"
        before = k6.pcg_iteration_fused.launches
        runs[str(dev)] = solve_static(model, force, tolerance=1e-8, variant=chosen)
        k6_launches = k6.pcg_iteration_fused.launches - before
        monkeypatch.delenv("CIVIWAVE_MEGA_PCG", raising=False)
        if on_card:
            assert (k6_launches > 0) == (variant == "mega")
    (ug, tg), (uc, tc) = runs[str(device)], runs["cpu"]
    assert tg.converged and tc.converged
    np.testing.assert_allclose(ug.cpu().numpy(), uc.numpy(), rtol=0,
                               atol=2.5e-4 * float(uc.abs().max()))


def test_dashpot_term_on_the_card_matches_plain(device):
    """The general operator with absorbing dashpots (damp_factor set) on
    CUDA: K7, G1 and the dashpot term against the plain operator."""
    cfg = cantilever_config(mesh={"path": "synthetic://box/6,6,3,tet"},
                            boundaries={"absorbing": ["SIDE_X1", "SIDE_Z0"]})
    mesh = box_mesh(6, 6, 3, side_groups=True)
    pre = preprocess.run(mesh, cfg)
    mats = [materials.make_properties(m) for m in cfg.materials]
    model, _, _ = pack.build_packed_model(mesh, pre, cfg, mats, device=device)
    assert model.has_damping
    damped = dataclasses.replace(model, damp_factor=1000.0)
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(
        model.vector_shape, dtype=np.float32), device=device)
    before = gops.add_dashpot_term.calls
    out = gops.apply_keff(damped, x, SS, MF)
    assert gops.add_dashpot_term.calls == before + 1
    ref = gops.apply_keff_plain(damped, x, SS, MF)
    _close(out, ref)
    assert float((ref - gops.apply_keff_plain(model, x, SS, MF)).abs().max()) > 0


# multigrid coarse levels: (cells, build_structured_model kwargs) of the
# fine grid; every level below it takes K1 with its mass correction
COARSE = {
    "even_15": ((15, 15, 15), {}),
    "xpad4": ((10, 6, 6), dict(pad_x_multiple=4)),
    "mixed_31x17x9": ((31, 17, 9), dict(fixed_axis_planes=("x0", "z1"))),
}


@pytest.mark.parametrize("case", sorted(COARSE))
def test_keff_on_coarse_levels_matches_plain(device, case):
    """K1 plus the mass correction on every multigrid level equals the
    plain operator (which reads the stored P^T m_f mass); where a level has
    a correction, K1 alone does not."""
    from civiwave_tpu_torch.ops.multigrid import attach_multigrid

    dims, kw = COARSE[case]
    mat = cantilever_config().materials[0]
    model, _ = build_structured_model(
        *dims, materials.make_properties(mat), mat.density, device=device, **kw
    )
    mg = attach_multigrid(model)
    assert mg.multigrid
    for lvl in mg.mg_levels:
        x = torch.as_tensor(np.random.default_rng(5).standard_normal(
            lvl.vector_shape, dtype=np.float32), device=device)
        before = k12.apply_keff_fused.launches
        out = tops.apply_keff_structured(lvl, x, SS, MF)
        torch.cuda.synchronize()
        assert k12.apply_keff_fused.launches == before + 1
        ref = tops.apply_keff_structured_plain(lvl, x, SS, MF)
        _close(out, ref)
        assert torch.equal(out[lvl.bc_mask], x[lvl.bc_mask])
        if lvl.mass_correction is not None:
            raw = k12.apply_keff_fused(lvl, x, SS, MF)
            assert float((raw - ref).abs().max()) > OP_TOL * float(ref.abs().max())


@pytest.mark.parametrize("variant", ["mg_auto", "mg_pipelined", "pipelined"])
def test_opt_in_solvers_16_cubed_match_the_cpu(device, variant):
    """On the 16^3 cantilever's Newmark system: the multigrid V-cycle (K1
    on every level) against the CPU's, and PCG with multigrid ('auto' =
    classic, and pipelined) and block-Jacobi pipelined (K2 without dots)
    against the CPU's same solve: converged, iterations within 1, u within
    2.5e-4 of max|u|."""
    from civiwave_tpu_torch.ops.multigrid import attach_multigrid
    from civiwave_tpu_torch.solver.pcg import solve_pcg

    mat = cantilever_config().materials[0]
    runs = {}
    for dev in (device, "cpu"):
        model, force = build_structured_model(
            16, 16, 16, materials.make_properties(mat), mat.density,
            traction=(0.0, 0.0, -1.0e6), device=dev)
        if variant.startswith("mg"):
            model = attach_multigrid(model)
            r = torch.as_tensor(np.random.default_rng(1).standard_normal(
                model.vector_shape, dtype=np.float32), device=dev)
            r = r.masked_fill(model.bc_mask, 0.0)
            z = model.apply_preconditioner(model.build_preconditioner(SS, MF), r)
            runs[f"z_{dev}"] = z.cpu()
        rhs = torch.where(model.bc_mask, model.bc_value, force)
        before = (k12.apply_pc_keff_fused.launches, k12.apply_keff_fused.launches)
        runs[str(dev)] = solve_pcg(
            model, rhs, SS, MF, 1e-7, 400, torch.zeros_like(rhs),
            variant="auto" if variant == "mg_auto" else "pipelined")
        if dev != "cpu":
            pc = k12.apply_pc_keff_fused.launches - before[0]
            k1 = k12.apply_keff_fused.launches - before[1]
            assert (pc > 0) == (variant == "pipelined") and k1 > 0
    (ug, tg), (uc, tc) = runs[str(device)], runs["cpu"]
    assert tg.converged and tc.converged
    assert abs(tg.iterations - tc.iterations) <= 1
    np.testing.assert_allclose(ug.cpu().numpy(), uc.numpy(), rtol=0,
                               atol=2.5e-4 * float(uc.abs().max()))
    if variant.startswith("mg"):
        _close(runs[f"z_{device}"], runs["z_cpu"])


# ---------------------------------------------------------------------------
# The f64 instances (precision.vectors: fp64) of K1/K5, K3, K7 and G1, each
# against its plain version in f64 at 1e-12 of max|ref|: an f32 round trip
# anywhere on the way would show at ~1e-7.  ss and mf are f64 values no f32
# holds.

F64_TOL = 1e-12
SS64, MF64 = 1.0000727000000001, 4000363.6000000001
F64_SHAPES = {
    "cube_16": ((15, 15, 15), {}),
    # Z = 41: one copy per element; Y and Z ragged against the tile
    "ragged_yz": SWEEP_SHAPES["ragged_yz"],
    # X = 65 nodes: a one-plane last chunk
    "x_last_chunk_one_plane": SWEEP_SHAPES["x_last_chunk_one_plane"],
    # Z = 64: 16-byte copies of two doubles; two z tiles
    "two_z_tiles": SWEEP_SHAPES["two_z_tiles"],
    "partial_fixes_33x19x45": SWEEP_SHAPES["partial_fixes_33x19x45"],
    "xpad4": SHAPES["xpad4"],
    "nx1": SHAPES["nx1"],
}


def _close64(out, ref):
    assert out.dtype == ref.dtype == torch.float64
    err = float((out - ref).abs().max())
    assert err <= F64_TOL * float(ref.abs().max()) + 1e-300, err


def _model64(device, case):
    dims, kw = F64_SHAPES[case]
    mat = cantilever_config().materials[0]
    model, _ = build_structured_model(
        *dims, materials.make_properties(mat), mat.density, device=device, **kw
    )
    x = torch.as_tensor(np.random.default_rng(13).standard_normal(model.vector_shape),
                        device=device)
    return model, x


@pytest.mark.parametrize("case", sorted(F64_SHAPES))
def test_keff_f64_matches_plain(device, case):
    from civiwave_tpu_torch.ops.cuda import keff_halo as k5

    model, x = _model64(device, case)
    before = (k12.apply_keff_fused.launches, k12.apply_keff_fused.launches_f64)
    out = k12.apply_keff_fused(model, x, SS64, MF64)
    torch.cuda.synchronize()
    assert (k12.apply_keff_fused.launches,
            k12.apply_keff_fused.launches_f64) == (before[0], before[1] + 1)
    # the class-table plain version, and the reference's inclusion-exclusion
    _close64(out, k5.keff_structured_halo_plain(model, x, None, SS64, MF64))
    _close64(out, k12.apply_keff_fused_plain(model, x, SS64, MF64))
    bc = model.bc_mask
    assert torch.equal(out[bc], x[bc])


@pytest.mark.parametrize("case", sorted(HALO))
def test_keff_halo_f64_matches_plain_and_k1(device, case, monkeypatch):
    """K5's f64 instance on every tile with its ghosts: against its plain
    version, the overlap split against one launch and the gathered tiles
    against K1's f64 instance, bit for bit."""
    from civiwave_tpu_torch.ops.cuda import keff_halo as k5
    from civiwave_tpu_torch.ops.structured_sharded import local_keff

    model, x, tiles = _halo_tiles(device, case)
    x = x.double()
    gathered = torch.empty_like(x)
    for local, xt, ghosts, (x0, y0, xl, yl) in tiles:
        xt = xt.double()
        ghosts = ghosts._replace(**{
            k: None if g is None else g.double() for k, g in ghosts._asdict().items()})
        before = k5.keff_structured_halo.launches_f64
        out = k5.keff_structured_halo(local, xt, ghosts, SS64, MF64)
        torch.cuda.synchronize()
        assert k5.keff_structured_halo.launches_f64 == before + 1
        _close64(out, k5.keff_structured_halo_plain(local, xt, ghosts, SS64, MF64))
        if xl >= 4:
            monkeypatch.setenv("CIVIWAVE_HALO_OVERLAP", "1")
            assert torch.equal(local_keff(local, xt, ghosts, SS64, MF64), out)
        gathered[:, x0:x0 + xl, y0:y0 + yl] = out
    assert torch.equal(gathered, k12.apply_keff_fused(model, x, SS64, MF64))


@pytest.mark.parametrize("case", sorted(HALO))
def test_block_jacobi_f64_with_offsets(device, case):
    model, x, tiles = _halo_tiles(device, case)
    pc = model.build_preconditioner(SS64, MF64)
    before = k3.apply_block_jacobi.launches_f64
    ref = k3.apply_block_jacobi(model, pc.table, x.double())
    assert k3.apply_block_jacobi.launches_f64 == before + 1
    _close64(ref, k3.apply_block_jacobi_plain(model, pc.table, x.double()))
    gathered = torch.empty_like(ref)
    for local, xt, _, (x0, y0, xl, yl) in tiles:
        z = k3.apply_block_jacobi(local, pc.table, xt.double())
        _close64(z, k3.apply_block_jacobi_plain(local, pc.table, xt.double()))
        gathered[:, x0:x0 + xl, y0:y0 + yl] = z
    torch.cuda.synchronize()
    assert torch.equal(gathered, ref)
    zb = ref[model.bc_mask]
    assert not zb.any() and not torch.signbit(zb).any()


@pytest.mark.parametrize("case", sorted(GENERAL))
def test_element_forces_and_assemble_f64_match_plain(device, case):
    model, x = _general(device, case)
    x = x.double()
    for block, wrapper, count in (
        ("tet", k7.tet_element_forces, model.padded_tet_count),
        ("hex", k7.hex_element_forces, model.padded_hex_count),
    ):
        if not count:
            continue
        before = (wrapper.launches, wrapper.launches_f64)
        rows = wrapper(model, x, SS)
        torch.cuda.synchronize()
        assert (wrapper.launches, wrapper.launches_f64) == (before[0], before[1] + 1)
        _close64(rows, k7.element_forces_plain(model, x, SS, block))
    rows = k7.element_force_rows(model, x, SS)
    assert rows.dtype == torch.float64
    before = g1.assemble_keff.launches_f64
    out = g1.assemble_keff(model, rows, x, MF)
    torch.cuda.synchronize()
    assert g1.assemble_keff.launches_f64 == before + 1
    # slot-order sums of the same rows: bit-equal, as the f32 instance
    assert torch.equal(out, g1.assemble_keff_plain(model, rows, x, MF))
    _close64(gops.apply_keff(model, x, SS, MF), gops.apply_keff_plain(model, x, SS, MF))


def test_fp64_simulation_runs_f64_kernels_only(device):
    """An fp64 build_simulation on CUDA (classic by 'auto'): K1 and K3 f64
    on every matvec and pc apply, no f32 kernel and no plain operator."""
    from civiwave_tpu_torch.ops import structured as ops

    cfg = cantilever_config(mesh={"path": "synthetic://box/15,15,15"},
                            precision={"vectors": "fp64", "reductions": "fp64"},
                            tol_runtime=1e-10, max_iters=400)
    sim = build_simulation(cfg, device=device)
    plain = []
    orig = ops.apply_keff_structured_plain
    ops.apply_keff_structured_plain = lambda *a, **k: plain.append(1) or orig(*a, **k)
    counters = (k12.apply_keff_fused, k3.apply_block_jacobi, k12.apply_pc_keff_fused,
                k6.pcg_iteration_fused)
    before = [(c.launches, getattr(c, "launches_f64", 0)) for c in counters]
    try:
        tel = sim.run(3)
    finally:
        ops.apply_keff_structured_plain = orig
    after = [(c.launches, getattr(c, "launches_f64", 0)) for c in counters]
    iters = sum(t.pcg_iterations for t in tel)
    assert all(t.pcg_converged for t in tel) and not plain
    assert sim.stepper.state.displacement.dtype == torch.float64
    (k1, k1d), (bj, bjd), (pc, _), (k6n, _) = (
        (a - b, ad - bd) for (a, ad), (b, bd) in zip(after, before))
    assert (k1, bj, pc, k6n) == (0, 0, 0, 0)
    assert k1d >= iters and bjd >= iters


# --- the sharded general path and absorbing shards (A11 part 1) ------------


def _tet_box(device, cells=(20, 4, 3), hex_elements=False, pad=64):
    cfg = cantilever_config()
    mesh = box_mesh(*cells, hex_elements=hex_elements)
    pre = preprocess.run(mesh, cfg)
    mats = [materials.make_properties(m) for m in cfg.materials]
    model, _, _ = pack.build_packed_model(mesh, pre, cfg, mats, pad_nodes=pad,
                                          pad_elems=pad, device=device)
    return model


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("hex_elements", [False, True], ids=["tet", "hex"])
def test_general_halo_shards_on_the_card(device, hex_elements, dtype):
    """K7 + G1 on each in-process shard's window (4 shards): the combined
    rows against the unsharded K7 + G1 at 1e-5 (f64 1e-12) of max, the
    rows off the ghost bands bit-equal, G1 on every window bit-equal to
    its plain version."""
    from chip_smoke import local_keff_general, local_windows
    from civiwave_tpu_torch.ops import general_sharded as gsh
    from civiwave_tpu_torch.parallel import sharding

    model = _tet_box(device, (24, 3, 3) if hex_elements else (20, 4, 3),
                     hex_elements)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        model.vector_shape), dtype=dtype, device=device)
    shards = sharding.local_general_shards(model, 4)
    for shard, (part, ghost) in zip(shards, local_windows(shards, x)):
        w, xw = shard.shard_window, gsh.window_x(part, ghost)
        rows = k7.element_force_rows(w, xw, SS)
        assert torch.equal(g1.assemble_keff(w, rows, xw, MF),
                           g1.assemble_keff_plain(w, rows, xw, MF))
    out = torch.cat(local_keff_general(shards, x, SS, MF))
    ref = gops.apply_keff(model, x, SS, MF)
    tol = 1e-12 if dtype == torch.float64 else OP_TOL
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    L, G = shards[0].local_rows, shards[0].halo_ghost
    off = torch.ones(model.padded_node_count, dtype=torch.bool, device=device)
    for s in range(1, 4):
        off[s * L:s * L + G] = False
    assert torch.equal(out[off], ref[off])


def test_general_path_on_one_rank(device):
    """A general-path simulation over a one-rank NCCL group: K7 and G1
    once per matvec, 'auto' classic, frames equal to the unsharded run's
    on the card."""
    from civiwave_tpu_torch.parallel import collectives, sharding

    cfg = cantilever_config(tol_runtime=2e-4, max_iters=300, dt=1e-3,
                            adaptive=False,
                            mesh={"path": "synthetic://box/16,6,6,tet"})
    ref = build_simulation(cfg, device=device)
    tel_ref = ref.run(3)
    try:
        sim = sharding.shard_simulation(build_simulation(cfg, device=device),
                                        sharding.make_shard_group(1, device))
        before = (k7.tet_element_forces.launches, g1.assemble_keff.launches)
        collectives.reset_counts()
        tel = sim.run(3)
        torch.cuda.synchronize()
        u = sim.stepper.displacement()
    finally:
        sharding.close_shard_group()
    iters = [t.pcg_iterations for t in tel]
    matvecs = 2 * len(tel) + sum(iters)
    assert k7.tet_element_forces.launches - before[0] == matvecs
    assert g1.assemble_keff.launches - before[1] == matvecs
    assert collectives.ppermute.calls == collectives.all_gather.calls == 0
    assert iters == [t.pcg_iterations for t in tel_ref]
    np.testing.assert_array_equal(u, ref.stepper.displacement())


def test_absorbing_basin_on_one_rank(device):
    """examples/seismic_basin.yaml at 24x24x12 over one-rank 1-D and 2-D
    NCCL groups: K5 + K3 with the shard's face terms, frames within the
    stepping tolerances of the unsharded run on the card."""
    from civiwave_tpu_torch.config.loader import load_config_from_file
    from civiwave_tpu_torch.parallel import sharding

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "seismic_basin.yaml")
    cfg = dataclasses.replace(load_config_from_file(path),
                              mesh_path="synthetic://box/24,24,12")
    ref = build_simulation(cfg, device=device)
    tel_ref = ref.run(4)
    for make in (lambda: sharding.make_shard_group(1, device),
                 lambda: sharding.make_shard_group_2d(1, 1, device)):
        try:
            sim = sharding.shard_simulation(build_simulation(cfg, device=device),
                                            make())
            tel = sim.run(4)
            u, a = sim.stepper.displacement(), sim.stepper.acceleration()
        finally:
            sharding.close_shard_group()
        assert all(abs(t.pcg_iterations - r.pcg_iterations) <= 1
                   for t, r in zip(tel, tel_ref))
        u_ref, a_ref = ref.stepper.displacement(), ref.stepper.acceleration()
        assert np.abs(u - u_ref).max() <= 2.5e-4 * np.abs(u_ref).max()
        assert np.abs(a - a_ref).max() <= 3e-3 * np.abs(a_ref).max()


@pytest.mark.parametrize("case", ["tet_cantilever", "seismic_basin"])
def test_launcher_across_two_gpus(device, case):
    """``parallel.launch --npx 2 --against-one-rank`` on the general path
    (the halo operator over NCCL) and on the absorbing basin (slabs):
    exit 0, the group's frames within the stepping tolerances of one
    rank's.  Skips below 2 GPUs."""
    import subprocess
    import sys

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 GPUs: one per rank")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = (["--cells", "40,10,10,tet"] if case == "tet_cantilever" else
            ["--scenario", os.path.join(repo, "examples", "seismic_basin.yaml")])
    proc = subprocess.run(
        [sys.executable, "-m", "civiwave_tpu_torch.parallel.launch", "--npx",
         "2", *args, "--frames", "3", "--against-one-rank", "--timeout", "240"],
        cwd=repo, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "against one rank: iterations" in proc.stdout


# --- heterogeneous grids: G3 (corner_gather) --------------------------------

# X = 33 (1 mod 32), a padded X, a dead +Y row, fixes on several faces;
# then the grids that cut G3's 8 x 32 node tiles, 9 x 33 cell tiles and
# 32-plane chunks (chip_smoke.G3_SHAPES): Y = 13, Z = 37 (not a multiple of
# 4 or 32), X = 65 (a one-plane last chunk) with a dead +Y row, and one
# cell along each axis
HETERO = {
    "x_1_mod_32": ((32, 5, 7), {}),
    "xpad4": ((6, 5, 4), dict(pad_x_multiple=4)),
    "ypad_row": ((5, 5, 3), dict(pad_y_multiple=4)),
    "odd_partial_fixes": SHAPES["odd_partial_fixes"],
    **{name: G3_SHAPES[name] for name in (
        "y13_z37", "x65_dead_row", "one_cell_x", "one_cell_y", "one_cell_z")},
}


def _hetero_model(device, case, seed=21):
    """A heterogeneous grid of HETERO[case]: lam0 (1 + U), mu0 (1 + U') per
    cell, U and U' uniform on [0, 1) from ``default_rng(seed)``."""
    dims, kw = HETERO[case]
    mat = cantilever_config().materials[0]
    props = materials.make_properties(mat)
    rng = np.random.default_rng(seed)
    model, force = build_structured_model(
        *dims, props, mat.density, device=device,
        lam_grid=props.lame.lam * (1.0 + rng.uniform(0.0, 1.0, dims)),
        mu_grid=props.lame.mu * (1.0 + rng.uniform(0.0, 1.0, dims)), **kw)
    assert not model.homogeneous
    return model, force


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(HETERO))
def test_corner_gather_kernel_matches_plain(device, case, dtype):
    """G3 against its plain version (the reference's corner-gather loop):
    1e-5 of max|ref| in f32, 1e-12 in f64 (the split A/B form sums in
    another order); constrained outputs equal x; one launch of the
    instance for the dtype."""
    from civiwave_tpu_torch.ops.cuda import corner_gather as g3

    model, _ = _hetero_model(device, case)
    x = torch.as_tensor(np.random.default_rng(22).standard_normal(model.vector_shape),
                        device=device).to(dtype)
    ss, mf = (SS, MF) if dtype == torch.float32 else (SS64, MF64)
    wrapper = g3.apply_keff_corner_gather
    before = (wrapper.launches, wrapper.launches_f64)
    out = model.apply_keff(x, ss, mf)
    torch.cuda.synchronize()
    f64 = int(dtype == torch.float64)
    assert (wrapper.launches, wrapper.launches_f64) == (
        before[0] + 1 - f64, before[1] + f64)
    ref = tops.apply_keff_structured_plain(model, x, ss, mf)
    tol = OP_TOL if dtype == torch.float32 else F64_TOL
    err = float((out - ref).abs().max())
    assert out.dtype == dtype and err <= tol * float(ref.abs().max()), err
    bc = model.bc_mask
    assert torch.equal(out[bc], x[bc])


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_corner_gather_on_a_uniform_grid_matches_k1(device, case):
    """A uniform grid marked heterogeneous: G3 within 3e-6 of max|K1 x|
    (the bound of the reference's stencil-against-corner-path test)."""
    from civiwave_tpu_torch.ops.cuda import corner_gather as g3

    model, x = _model(device, case)
    k1 = k12.apply_keff_fused(model, x, SS, MF)
    out = g3.apply_keff_corner_gather(
        dataclasses.replace(model, homogeneous=False), x, SS, MF)
    torch.cuda.synchronize()
    assert float((out - k1).abs().max()) <= 3e-6 * float(k1.abs().max())


def test_constant_stencil_kernels_refuse_a_heterogeneous_grid(device):
    model, _ = _hetero_model(device, "xpad4")
    x = torch.zeros(model.vector_shape, device=device)
    with pytest.raises(ValueError, match="heterogeneous"):
        k12.apply_keff_fused(model, x, SS, MF)
    with pytest.raises(ValueError, match="heterogeneous"):
        k12.apply_pc_keff_fused(model, torch.zeros((6, 3, 3, 3), device=device),
                                x, SS, MF)


@pytest.mark.parametrize("precision", ["fp32", "fp64"])
def test_heterogeneous_cantilever_runs_g3_only(device, precision):
    """A heterogeneous 32x5x7 cantilever stepped on the card and on the
    CPU (the plain version): iterations within 1, u within 2.5e-4 and a
    within 3e-3 of max; on the card G3's instance for the precision on
    every matvec, no K1, K2, K3, K4 or K6."""
    from civiwave_tpu_torch.ops.cuda import corner_gather as g3
    from civiwave_tpu_torch.solver.stepper import NewmarkStepper

    cfg = cantilever_config(tol_runtime=2e-4, max_iters=120)
    ray = materials.compute_rayleigh(cfg.damping)
    runs = {}
    counters = (k12.apply_keff_fused, k12.apply_pc_keff_fused,
                k3.apply_block_jacobi, k4.interior_stencil,
                k6.pcg_iteration_fused)
    for dev in (device, torch.device("cpu")):
        model, force = _hetero_model(dev, "x_1_mod_32")
        stepper = NewmarkStepper(model, model.zero_state(), force, ray,
                                 cfg.solver, cfg.time, vector_precision=precision)
        before = ([(c.launches, getattr(c, "launches_f64", 0)) for c in counters],
                  (g3.apply_keff_corner_gather.launches,
                   g3.apply_keff_corner_gather.launches_f64))
        tel = [stepper.step(0.001 * i) for i in range(4)]
        torch.cuda.synchronize()
        after = ([(c.launches, getattr(c, "launches_f64", 0)) for c in counters],
                 (g3.apply_keff_corner_gather.launches,
                  g3.apply_keff_corner_gather.launches_f64))
        runs[dev.type] = (tel, stepper.state, before, after)
    tel, state, before, after = runs["cuda"]
    ctel, cstate, _, _ = runs["cpu"]
    assert all(t.pcg_converged for t in tel)
    assert before[0] == after[0]
    launched = [a - b for a, b in zip(after[1], before[1])]
    iters = sum(t.pcg_iterations for t in tel)
    assert launched[int(precision == "fp64")] >= iters
    assert launched[int(precision != "fp64")] == 0
    for a, b in zip(tel, ctel):
        assert abs(a.pcg_iterations - b.pcg_iterations) <= 1
    for name, tol in (("displacement", 2.5e-4), ("acceleration", 3e-3)):
        got, ref = getattr(state, name).cpu(), getattr(cstate, name)
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())


def test_corner_gather_takes_the_mass_of_per_cell_densities(device):
    """A grid of per-cell lam, mu and rho (its m8 NaN, which no kernel may
    read): G3 against its plain version at 1e-5 of max|ref|, finite."""
    dims, kw = HETERO["x_1_mod_32"]
    mat = cantilever_config().materials[0]
    props = materials.make_properties(mat)
    rng = np.random.default_rng(23)
    model, _ = build_structured_model(
        *dims, props, mat.density, device=device, **kw,
        lam_grid=props.lame.lam * (1.0 + rng.uniform(0.0, 1.0, dims)),
        mu_grid=props.lame.mu * (1.0 + rng.uniform(0.0, 1.0, dims)),
        rho_grid=rng.uniform(1500.0, 8000.0, dims))
    assert np.isnan(model.m8)
    x = torch.as_tensor(np.random.default_rng(24).standard_normal(model.vector_shape),
                        dtype=torch.float32, device=device)
    out = model.apply_keff(x, SS, MF)
    ref = tops.apply_keff_structured_plain(model, x, SS, MF)
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= OP_TOL * float(ref.abs().max())


def test_box_regions_scenario_steps_on_g3_through_build_simulation(device):
    """examples/seismic_column_box.yaml at 32 x 5 x 7 cells, three frames
    through build_simulation on the card and on the CPU: classic PCG,
    iterations within 1, u within 2.5e-4 of max; on the card G3 on every
    matvec and no constant-stencil kernel."""
    from civiwave_tpu_torch.config.loader import load_config_from_file
    from civiwave_tpu_torch.ops.cuda import corner_gather as g3

    cfg = load_config_from_file(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "examples", "seismic_column_box.yaml"))
    cfg = dataclasses.replace(cfg, mesh_path="synthetic://box/32,5,7,0.25")
    counters = (k12.apply_keff_fused, k12.apply_pc_keff_fused,
                k3.apply_block_jacobi, k4.interior_stencil, k6.pcg_iteration_fused)
    runs = {}
    for dev in (device, torch.device("cpu")):
        sim = build_simulation(cfg, device=dev)
        assert sim.structured and not sim.model.homogeneous
        before = [c.launches for c in counters], g3.apply_keff_corner_gather.launches
        tel = sim.run(3)
        torch.cuda.synchronize()
        after = [c.launches for c in counters], g3.apply_keff_corner_gather.launches
        runs[dev.type] = (tel, sim.stepper.displacement(), sim.stepper.pcg_variant(),
                          before, after)
    tel, u, variant, before, after = runs["cuda"]
    ctel, cu, _, _, _ = runs["cpu"]
    assert variant == "classic" and all(t.pcg_converged for t in tel)
    assert before[0] == after[0]
    assert after[1] - before[1] >= sum(t.pcg_iterations for t in tel)
    for a, b in zip(tel, ctel):
        assert abs(a.pcg_iterations - b.pcg_iterations) <= 1
    assert np.abs(u - cu).max() <= 2.5e-4 * np.abs(cu).max()


# --- G3 on a shard: plane ranges, ghost planes, rows and cells --------------

# name -> (cells, build options, (npx, npy), 2-D): the reference's sharded
# heterogeneous cuts (tests/test_sharding.py:468, :852), 4-plane slabs
# (the overlap split), 33-plane slabs (two X chunks, the second of one
# plane) with a dead +Y row, ragged tiles with fixes on several faces and
# tiles of 21 x 9 nodes (two y tiles each, the +Y ghost row inside the
# second one's halo)
HETERO_CUTS = {
    "1d_15x6x6_over_4": ((15, 6, 6), {}, (4, 1), False),
    "1d_15x6x6_over_8": ((15, 6, 6), {}, (8, 1), False),
    "2d_7x4x5_on_2x2": ((7, 4, 5), {}, (2, 2), True),
    "2d_7x4x5_on_4x2": ((7, 4, 5), {}, (4, 2), True),
    "1d_64x4x4_dead_row_over_2": ((64, 4, 4), dict(pad_y_multiple=2),
                                  (2, 1), False),
    "2d_odd_partial_fixes_on_2x2": (G3_SHAPES["odd_partial_fixes"][0],
                                    G3_SHAPES["odd_partial_fixes"][1],
                                    (2, 2), True),
    "2d_41x17x63_on_2x2": ((41, 17, 63), {}, (2, 2), True),
}


def _hetero_cut(device, case, dtype):
    """(whole model, x, [(tile model, x block, x ghosts, (x0, y0, Xl,
    Yl))]) of a heterogeneous grid cut without a process group: lam0 (1 +
    U), mu0 (1 + U') per cell from ``default_rng(23)``."""
    from civiwave_tpu_torch.ops.structured_sharded import cut_ghosts
    from civiwave_tpu_torch.parallel import sharding

    dims, kw, shape, two_d = HETERO_CUTS[case]
    mat = cantilever_config().materials[0]
    props = materials.make_properties(mat)
    rng = np.random.default_rng(23)
    kw = {**kw, "pad_x_multiple": shape[0],
          "pad_y_multiple": max(shape[1], kw.get("pad_y_multiple", 1))}
    model, _ = build_structured_model(
        *dims, props, mat.density, device=device,
        lam_grid=props.lame.lam * (1.0 + rng.uniform(0.0, 1.0, dims)),
        mu_grid=props.lame.mu * (1.0 + rng.uniform(0.0, 1.0, dims)), **kw)
    assert not model.homogeneous
    x = torch.as_tensor(rng.standard_normal(model.vector_shape),
                        device=device).to(dtype)
    tiles = []
    for local in sharding.local_tiles(model, shape, two_d):
        x0, y0, (xl, yl) = local.x0, local.y0, local.local_extent
        tiles.append((local, sharding.cut_block(x, x0, y0, xl, yl),
                      cut_ghosts(x, x0, y0, xl, yl, two_d), (x0, y0, xl, yl)))
    return model, x, tiles


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(HETERO_CUTS))
def test_corner_gather_cuts_match_plain_and_the_whole_grid(device, case, dtype,
                                                            monkeypatch):
    """Each tile: one G3 launch against G3's plain shard version (1e-5 of
    max|ref| in f32, 1e-12 in f64), the overlap split's three launches
    (slabs of 4 or more planes) equal to one; gathered, every cut equals
    the whole-grid G3 bit for bit."""
    from civiwave_tpu_torch.ops.cuda import corner_gather as g3
    from civiwave_tpu_torch.ops.structured_sharded import local_keff

    ss, mf = (SS, MF) if dtype == torch.float32 else (SS64, MF64)
    tol = OP_TOL if dtype == torch.float32 else F64_TOL
    model, x, tiles = _hetero_cut(device, case, dtype)
    wrapper = g3.apply_keff_corner_gather
    key = "launches" if dtype == torch.float32 else "launches_f64"
    whole = wrapper(model, x, ss, mf)
    gathered = torch.full_like(x, float("nan"))
    for local, xt, ghosts, (x0, y0, xl, yl) in tiles:
        before = getattr(wrapper, key)
        out = wrapper(local, xt, ss, mf, ghosts)
        torch.cuda.synchronize()
        assert getattr(wrapper, key) == before + 1
        ref = g3.apply_keff_corner_gather_plain_shard(local, xt, ss, mf, ghosts)
        err = float((out - ref).abs().max())
        assert err <= tol * float(ref.abs().max()), (x0, y0, err)
        if xl >= 4:  # the overlap split's three launches write the same bits
            monkeypatch.setenv("CIVIWAVE_HALO_OVERLAP", "1")
            before = getattr(wrapper, key)
            assert torch.equal(local_keff(local, xt, ghosts, ss, mf), out)
            assert getattr(wrapper, key) == before + 3
        gathered[:, x0:x0 + xl, y0:y0 + yl] = out
    assert torch.equal(gathered, whole)


@pytest.mark.parametrize("case", sorted(HETERO_CUTS))
def test_corner_gather_missing_ghosts_read_as_zero(device, case):
    """At a global end a ghost of None (x, the mask, the ghost cell plane
    or row) gives the bits of the zero ghost a group delivers there."""
    from civiwave_tpu_torch.ops.cuda import corner_gather as g3

    model, _, tiles = _hetero_cut(device, case, torch.float32)
    for local, xt, ghosts, (x0, y0, xl, yl) in tiles:
        ends = {"x_lo": x0 == 0, "x_hi": x0 + xl == model.grid_shape[0],
                "y_lo": y0 == 0, "y_hi": y0 + yl == model.grid_shape[1]}
        cut = {k: None for k, end in ends.items()
               if end and getattr(ghosts, k) is not None}
        cells = {k: None for k in ("x_lo", "y_lo")
                 if ends[k] and getattr(local.cell_ghosts, k) is not None}
        if not cut and not cells:
            continue
        bare = dataclasses.replace(
            local, bc_ghosts=local.bc_ghosts._replace(**cut),
            cell_ghosts=local.cell_ghosts._replace(**cells))
        assert torch.equal(
            g3.apply_keff_corner_gather(bare, xt, SS, MF, ghosts._replace(**cut)),
            g3.apply_keff_corner_gather(local, xt, SS, MF, ghosts))


def test_corner_gather_refuses_wrong_ghosts(device):
    from civiwave_tpu_torch.ops.cuda import corner_gather as g3

    _, _, tiles = _hetero_cut(device, "2d_7x4x5_on_2x2", torch.float32)
    local, xt, ghosts, _ = tiles[-1]
    with pytest.raises(ValueError):  # a 1-D plane on a tile
        g3.apply_keff_corner_gather(local, xt, SS, MF,
                                    ghosts._replace(x_lo=ghosts.x_lo[:, 1:-1]))
    with pytest.raises(ValueError):
        g3.apply_keff_corner_gather(local, xt, SS, MF, ghosts, planes=(0, 99))
    short = local.cell_ghosts._replace(x_lo=local.cell_ghosts.x_lo[:, 1:])
    with pytest.raises(ValueError):
        g3.apply_keff_corner_gather(
            dataclasses.replace(local, cell_ghosts=short), xt, SS, MF, ghosts)


@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
def test_heterogeneous_cantilever_runs_sharded_on_one_rank(device, two_d,
                                                           monkeypatch):
    """A one-rank NCCL group (1-D and 2-D): 'auto' is fused, every matvec is
    G3 (three launches with the overlap split), no other kernel runs, one
    f64 (3,) all-reduce per iteration, and the frames match the unsharded
    fused run on the card (iterations +-1, u 2.5e-4, a 3e-3 of max)."""
    from civiwave_tpu_torch.ops.cuda import corner_gather as g3
    from civiwave_tpu_torch.ops.cuda import keff_halo as k5
    from civiwave_tpu_torch.parallel import collectives, sharding
    from civiwave_tpu_torch.solver.stepper import NewmarkStepper

    monkeypatch.delenv("CIVIWAVE_HALO_OVERLAP", raising=False)
    model, force = _hetero_model(device, "x_1_mod_32")
    cfg = cantilever_config(tol_runtime=2e-4, max_iters=120, dt=1e-3,
                            adaptive=False)
    ray = materials.compute_rayleigh(cfg.damping)

    def frames(m, f, variant):
        stepper = NewmarkStepper(m, m.zero_state(), f, ray, cfg.solver, cfg.time)
        stepper.solver_variant = variant
        tel = [stepper.step(stepper.accumulated_time) for _ in range(4)]
        return tel, stepper.state

    tel_ref, state_ref = frames(model, force, "fused")
    counters = (k12.apply_keff_fused, k12.apply_pc_keff_fused,
                k3.apply_block_jacobi, k4.interior_stencil,
                k6.pcg_iteration_fused, k5.keff_structured_halo)
    try:
        group = (sharding.make_shard_group_2d(1, 1, device) if two_d
                 else sharding.make_shard_group(1, device))
        sm, _, sf = sharding.shard_structured(model, model.zero_state(), force,
                                              group)
        before = [c.launches for c in counters]
        g3_before = g3.apply_keff_corner_gather.launches
        collectives.reset_counts()
        tel, state = frames(sm, sf, "auto")
        torch.cuda.synchronize()
    finally:
        sharding.close_shard_group()
    iters = [t.pcg_iterations for t in tel]
    matvecs = 3 * len(tel) + sum(iters)
    assert g3.apply_keff_corner_gather.launches - g3_before == 3 * matvecs
    assert [c.launches for c in counters] == before
    assert collectives.psum.shapes[(torch.float64, (3,))] == sum(iters)
    assert collectives.ppermute.calls == (4 if two_d else 2) * matvecs
    assert all(t.pcg_converged for t in tel)
    assert all(abs(a - b.pcg_iterations) <= 1 for a, b in zip(iters, tel_ref))
    for name, tol in (("displacement", 2.5e-4), ("acceleration", 3e-3)):
        got, ref = getattr(state, name), getattr(state_ref, name)
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
