"""The CUDA kernels K1-K3 against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (the
kernels are compiled with nvcc for sm_90a at first use and cannot run
elsewhere).  This file imports no jax, so it also runs on a GPU machine
without it:

    python3 -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances: operator and preconditioner outputs at 1e-5 * max|ref|, dots
at rtol 1e-5 (the sums run in another order than the plain version's).
"""

import numpy as np
import pytest
import torch

from civiwave_tpu_torch.mesh.structured import build_structured_model
from civiwave_tpu_torch.ops.cuda import block_jacobi_apply as k3
from civiwave_tpu_torch.ops.cuda import structured_stencil as k12
from civiwave_tpu_torch.physics import materials
from civiwave_tpu_torch.runner import build_simulation
from civiwave_tpu_torch.utils.synthetic import cantilever_config

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


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda", 0)


def _model(device, case):
    dims, kw = SHAPES[case]
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


@pytest.mark.parametrize("case", sorted(SHAPES))
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


@pytest.mark.parametrize("case", sorted(SHAPES))
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


def test_wrappers_refuse_wrong_dtype_and_layout(device):
    model, x = _model(device, "xpad4")
    with pytest.raises(TypeError):
        k12.apply_keff_fused(model, x.double(), SS, MF)
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
