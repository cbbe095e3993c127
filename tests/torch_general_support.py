"""Shared helpers for the general-path parity tests of the port.

Each helper makes the same mesh, scenario and packed model in both
packages from the same arguments: the JAX package (``civiwave_tpu``, on the
CPU) is the oracle, ``civiwave_tpu_torch`` the port under test.  Models of
the two packages may number nodes differently (the port decides RCM on the
(max, sum) element span), so whole-model results are compared in nodal
order through ``to_nodal``; ``to_port_packed`` carries a JAX model across
through ``convert`` when the same element order is needed.
"""

from __future__ import annotations

import os

import numpy as np

from civiwave_tpu.config.loader import parse_config_node as jparse_config_node
from civiwave_tpu.mesh import pack as jpack
from civiwave_tpu.mesh import preprocess as jpreprocess
from civiwave_tpu.mesh.gmsh import load_gmsh_file as jload_gmsh
from civiwave_tpu.physics import materials as jmaterials
from civiwave_tpu.utils import synthetic as jsynthetic
from civiwave_tpu_torch import convert
from civiwave_tpu_torch.config.loader import parse_config_node
from civiwave_tpu_torch.mesh import pack, preprocess
from civiwave_tpu_torch.mesh.gmsh import load_gmsh_file
from civiwave_tpu_torch.physics import materials
from civiwave_tpu_torch.utils import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLUMN_MSH = os.path.join(REPO, "examples", "column.msh")
COLUMN_YAML = os.path.join(REPO, "examples", "seismic_column_tet.yaml")

# the operator tolerance of BASELINE.md per DOF, max(1e-4, 3e-4 |ref|),
# floored at 1e-6 max|ref| as tests/test_pcg.py:75-78 does (E ~ 1e11 makes
# the absolute values huge)
OP_REL, OP_ABS, OP_FLOOR = 3e-4, 1e-4, 1e-6
U_TOL, A_TOL = 2.5e-4, 3e-3  # BASELINE stepping tolerances, of max|ref|

# the two-material seismic column (examples/seismic_column_tet.yaml)
COLUMN_NODE = {
    "mesh": {"path": COLUMN_MSH},
    "materials": [
        {"name": "rock", "E": 5.0e10, "nu": 0.25, "rho": 2700.0},
        {"name": "soil", "E": 2.0e8, "nu": 0.35, "rho": 1800.0},
    ],
    "assignments": [
        {"group": "ROCK_LOWER", "material": "rock"},
        {"group": "SOIL_UPPER", "material": "soil"},
    ],
    "loads": {
        "gravity": [0.0, 0.0, -9.81],
        "tractions": [{"group": "TOP_FACE", "value": [2.0e5, 0.0, 0.0]}],
    },
    "dirichlet": {"fixes": [{"group": "FIXED_BASE", "dof": ["x", "y", "z"]}]},
}


def configs(**extra):
    """(port Config, JAX Config) of the steel cantilever with ``extra``
    sections replaced."""
    return (
        synthetic.cantilever_config(**extra),
        jsynthetic.cantilever_config(**extra),
    )


def mesh_pair(kind: str):
    """(port mesh, JAX mesh) of one test mesh kind, each built by its own
    package."""
    if kind == "column":
        return load_gmsh_file(COLUMN_MSH), jload_gmsh(COLUMN_MSH)
    if kind == "tet":
        args, kw = (5, 4, 3), {}
    elif kind == "hex":
        args, kw = (6, 5, 4), dict(hex_elements=True)
    elif kind in ("shuffled", "mixed"):
        args, kw = (5, 5, 4), dict(hex_elements=True)
    else:
        raise ValueError(kind)
    pm, jm = synthetic.box_mesh(*args, **kw), jsynthetic.box_mesh(*args, **kw)
    if kind == "shuffled":
        pm = synthetic.shuffle_mesh_nodes(pm, seed=5)
        jm = jsynthetic.shuffle_mesh_nodes(jm, seed=5)
    if kind == "mixed":
        # the same arrays in both packages' Mesh objects
        pm = synthetic.split_last_hex(pm)
        jm = synthetic.split_last_hex(jm)
    return pm, jm


def config_pair(kind: str):
    """(port Config, JAX Config) for a mesh kind: the two-material column
    scenario for "column", the steel cantilever otherwise."""
    if kind == "column":
        node = {
            **COLUMN_NODE,
            "damping": {"xi": 0.05, "w1": 5.0, "w2": 50.0},
            "time": {"dt": 0.002, "adaptive": False},
            "solver": {"type": "pcg", "preconditioner": "block_jacobi",
                       "tol_runtime": 2.0e-4, "tol_pause": 1.0e-5,
                       "max_iters": 300},
            "precision": {"vectors": "fp32", "reductions": "fp64"},
            "output": {"vtu_stride": 5, "probes": [0]},
        }
        return parse_config_node(node), jparse_config_node(node)
    return configs()


def model_pair(kind: str, **pads):
    """Both packages' (mesh, preprocess, config, model, force) tuples."""
    (pm, jm), (pc, jc) = mesh_pair(kind), config_pair(kind)
    ppre, jpre = preprocess.run(pm, pc), jpreprocess.run(jm, jc)
    pmats = [materials.make_properties(m) for m in pc.materials]
    jmats = [jmaterials.make_properties(m) for m in jc.materials]
    pmodel, _, pforce = pack.build_packed_model(
        pm, ppre, pc, pmats, device="cpu", **pads
    )
    jmodel, _, jforce = jpack.build_packed_model(jm, jpre, jc, jmats, **pads)
    return (pm, ppre, pc, pmodel, pforce), (jm, jpre, jc, jmodel, jforce)


def to_port_packed(jm, device="cpu"):
    """The JAX packed model handed over through ``convert`` (same arrays,
    same element order and node numbering)."""
    arrays = {name: np.asarray(getattr(jm, name)) for name in convert.PACKED_ARRAYS}
    for name in (*convert.PACKED_OPTIONAL, *convert.PACKED_HALO):
        value = getattr(jm, name)
        arrays[name] = None if value is None else np.asarray(value)
    meta = {name: getattr(jm, name)
            for name in (*convert.PACKED_META, *convert.PACKED_HALO_META)}
    meta["has_damping"] = jm.has_damping
    return convert.packed_model_from_arrays(arrays, meta, device)


def assert_operator_close(got, ref):
    """BASELINE operator tolerance per DOF."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    tol = np.maximum(OP_ABS, OP_REL * np.abs(ref))
    tol = np.maximum(tol, OP_FLOOR * np.abs(ref).max())
    np.testing.assert_array_less(np.abs(got - ref), tol + 1e-30)
