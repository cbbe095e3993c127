"""The port's scenario loader equals the reference loader.

Every shipped scenario parses to the same dataclasses (compared through
``dataclasses.asdict``, less the port's ``box_regions``, which the
reference's Config lacks and which holds the scenario's regions only
where it has the node), and documents the reference rejects are rejected
by the port with the same ConfigError message and breadcrumbs.
"""

import copy
import dataclasses
import glob
import os

import pytest
import torch

from civiwave_tpu.config import loader as jloader
from civiwave_tpu.utils.errors import ConfigError as JConfigError
from civiwave_tpu_torch.config import loader as tloader
from civiwave_tpu_torch.physics import materials as tmaterials
from civiwave_tpu_torch.utils.errors import ConfigError as TConfigError
from civiwave_tpu_torch.utils.synthetic import cantilever_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = sorted(
    glob.glob(os.path.join(REPO, "examples", "*.yaml"))
    + glob.glob(os.path.join(REPO, "tests", "data", "*.yaml"))
)


@pytest.mark.parametrize(
    "path", SCENARIOS, ids=[os.path.relpath(p, REPO) for p in SCENARIOS]
)
def test_loader_matches_reference(path):
    ours = tloader.load_config_from_file(path)
    ref = jloader.load_config_from_file(path)
    assert _as_reference(ours) == dataclasses.asdict(ref)
    with open(path, encoding="utf-8") as f:
        has_regions = "box_regions:" in f.read()
    assert bool(ours.box_regions) == has_regions


def _as_reference(cfg):
    """``asdict`` of the port's Config without its ``box_regions``."""
    fields = dataclasses.asdict(cfg)
    del fields["box_regions"]
    return fields


_BASE = {
    "mesh": {"path": "synthetic://box/4,2,2"},
    "materials": [{"name": "steel", "E": 2.0e11, "nu": 0.3, "rho": 7800.0}],
    "assignments": [{"group": "SOLID", "material": "steel"}],
    "damping": {"xi": 0.02, "w1": 10.0, "w2": 100.0},
    "time": {"dt": 0.001, "adaptive": False},
    "solver": {"type": "pcg", "preconditioner": "block_jacobi",
               "tol_runtime": 2e-4, "tol_pause": 1e-5, "max_iters": 50},
    "precision": {"vectors": "fp32", "reductions": "fp64"},
    "loads": {"gravity": [0.0, 0.0, -9.81]},
    "dirichlet": {"fixes": [{"group": "FIXED", "dof": ["x", "y", "z"]}]},
    "output": {"vtu_stride": 1},
}


def _mutate(path, value):
    node = copy.deepcopy(_BASE)
    target = node
    for key in path[:-1]:
        target = target[key]
    if value is None:
        del target[path[-1]]
    else:
        target[path[-1]] = value
    return node


_BAD = {
    "nu_out_of_range": (("materials",), [{"name": "a", "E": 1.0, "nu": 0.6, "rho": 1.0}]),
    "no_mesh": (("mesh",), None),
    "damping_w2_below_w1": (("damping", "w2"), 5.0),
    "dt_negative": (("time", "dt"), -1.0),
    "max_iters_zero": (("solver", "max_iters"), 0),
    "bad_dof": (("dirichlet", "fixes"), [{"group": "FIXED", "dof": ["q"]}]),
    "unknown_material": (("assignments",), [{"group": "SOLID", "material": "x"}]),
    "bad_warm_start": (("solver", "warm_start_policy"), "bogus"),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_rejections_match_reference(case):
    node = _mutate(*_BAD[case])
    with pytest.raises(JConfigError) as ref:
        jloader.parse_config_node(node)
    with pytest.raises(TConfigError) as ours:
        tloader.parse_config_node(node)
    assert ours.value.message == ref.value.message
    assert ours.value.context == ref.value.context


def test_yaml_string_and_missing_file_errors_match(tmp_path):
    text = "mesh: [unclosed"
    with pytest.raises(JConfigError) as ref:
        jloader.load_config_from_string(text)
    with pytest.raises(TConfigError) as ours:
        tloader.load_config_from_string(text)
    assert str(ours.value) == str(ref.value)
    missing = str(tmp_path / "nope.yaml")
    with pytest.raises(TConfigError) as ours:
        tloader.load_config_from_file(missing)
    assert "unable to open config file" in ours.value.message


def test_cantilever_config_and_materials_match_reference():
    from civiwave_tpu.physics import materials as jmaterials
    from civiwave_tpu.utils.synthetic import cantilever_config as jcantilever

    kw = dict(tol_runtime=2e-4, max_iters=120, dt=1e-3,
              mesh={"path": "synthetic://box/255,255,255"})
    ours, ref = cantilever_config(**kw), jcantilever(**kw)
    assert ours.box_regions == ()
    assert _as_reference(ours) == dataclasses.asdict(ref)
    t, j = tmaterials.make_properties(ours.materials[0]), jmaterials.make_properties(
        ref.materials[0]
    )
    assert dataclasses.astuple(t.lame) == dataclasses.astuple(j.lame)
    assert (t.stiffness == j.stiffness).all()
    assert dataclasses.astuple(
        tmaterials.compute_rayleigh(ours.damping)
    ) == dataclasses.astuple(jmaterials.compute_rayleigh(ref.damping))
