"""The PyTorch port imports without jax (and its config path without pyyaml).

The machine the port runs on has no jax, so ``civiwave_tpu_torch`` must
never import it, directly or through ``civiwave_tpu``.
"""

import os
import pkgutil
import re
import subprocess
import sys

import torch

import civiwave_tpu_torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(REPO, "civiwave_tpu_torch")


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            civiwave_tpu_torch.__path__, "civiwave_tpu_torch."
        )
    )


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=120,
    )


def test_every_module_imports_with_jax_blocked():
    modules = _modules()
    for name in (
        "runner", "ops.cuda.structured_stencil", "mesh.gmsh", "mesh.pack",
        "mesh.renumber", "ops.apply_keff", "ops.block_jacobi",
        "ops.cuda.element_forces", "ops.cuda.assemble_csr", "physics.oracle",
        "ops.cuda.pcg_iteration", "ops.cuda.interior_stencil",
        "ops.cuda.keff_boundary", "ops.cuda.keff_halo", "ops.cuda.corner_gather",
        "ops.structured_sharded", "parallel.sharding", "parallel.collectives",
        "parallel.launch", "parallel.general_halo", "ops.general_sharded", "solver.static", "physics.absorbing", "post.derived",
        "post.vtu", "post.native_vtu", "post.probes", "post.structured_fields",
        "post.output", "post.snapshot",
    ):
        assert f"civiwave_tpu_torch.{name}" in modules
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['civiwave_tpu'] = None\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_source_file_imports_jax():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+civiwave_tpu\b"
        r"|from\s+civiwave_tpu(\.|\s))",
        re.MULTILINE,
    )
    offenders = []
    for root, _, files in os.walk(PKG_DIR):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path, encoding="utf-8") as handle:
                    if pattern.search(handle.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert offenders == []


def test_structured_route_runs_without_pyyaml():
    """parse_config_node and the whole CPU route need no pyyaml; only
    load_config_from_file imports it."""
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['jax'] = None\n"
        "from civiwave_tpu_torch.runner import build_simulation\n"
        "from civiwave_tpu_torch.utils.synthetic import cantilever_config\n"
        "cfg = cantilever_config(tol_runtime=2e-4, max_iters=120,\n"
        "                        mesh={'path': 'synthetic://box/4,3,3'})\n"
        "sim = build_simulation(cfg, device='cpu')\n"
        "tel = sim.run(2)\n"
        "assert all(t.pcg_converged for t in tel)\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_general_route_runs_without_pyyaml():
    """The general gather path (a tet box) on the CPU needs neither jax
    nor pyyaml."""
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['civiwave_tpu'] = None\n"
        "from civiwave_tpu_torch.runner import build_simulation\n"
        "from civiwave_tpu_torch.utils.synthetic import cantilever_config\n"
        "cfg = cantilever_config(tol_runtime=2e-4, max_iters=200,\n"
        "                        mesh={'path': 'synthetic://box/3,2,2,tet'})\n"
        "sim = build_simulation(cfg, device='cpu')\n"
        "assert type(sim.model).__name__ == 'PackedModel'\n"
        "tel = sim.run(2)\n"
        "assert all(t.pcg_converged for t in tel)\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_soil_column_runs_without_jax():
    """The slender route (forced onto a small soil column) with its
    absorbing base, on the CPU, needs neither jax nor pyyaml."""
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['civiwave_tpu'] = None\n"
        "from civiwave_tpu_torch.ops import structured as ops\n"
        "from civiwave_tpu_torch.runner import build_simulation\n"
        "from civiwave_tpu_torch.utils.synthetic import soil_column_config\n"
        "ops._FLAT_INTERIOR_NODE_THRESHOLD = 0\n"
        "sim = build_simulation(soil_column_config(cells=(12, 3, 3)), device='cpu')\n"
        "assert sim.model.absorb_faces == ('x0',)\n"
        "assert ops.slender_route(sim.model, sim.stepper.state.displacement.dtype)\n"
        "tel = sim.run(3)\n"
        "assert all(t.pcg_converged for t in tel)\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
