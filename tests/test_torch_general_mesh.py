"""Host side of the port's general gather path against the JAX package.

* the Gmsh parser, ``box_mesh`` and ``shuffle_mesh_nodes`` give the same
  arrays and groups as the reference from the same input and seed;
* ``preprocess.run`` tables equal the reference's within 1e-12 relative,
  and its error messages are the reference's;
* RCM renumbering: the same permutation as the reference's ``plan_rcm``,
  and the (max, sum) lexicographic decision.
"""

import numpy as np
import pytest

from civiwave_tpu.mesh import preprocess as jpreprocess
from civiwave_tpu.mesh import renumber as jrenumber
from civiwave_tpu.mesh.gmsh import load_gmsh_from_string as jload_string
from civiwave_tpu.utils.errors import CwfError as JCwfError
from civiwave_tpu_torch.mesh import preprocess, renumber
from civiwave_tpu_torch.mesh.gmsh import load_gmsh_file, load_gmsh_from_string
from civiwave_tpu_torch.utils.errors import CwfError, MeshError, PreprocessError
from torch_general_support import COLUMN_MSH, REPO, config_pair, configs, mesh_pair

MESH_FIELDS = (
    "node_positions", "node_original_ids", "elements", "element_node_counts",
    "element_physical_group", "element_original_ids", "surfaces",
    "surface_node_counts", "surface_physical_group", "surface_original_ids",
)
KINDS = ["tet", "hex", "shuffled", "mixed", "column"]


def assert_same_mesh(ours, ref):
    for name in MESH_FIELDS:
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert [(g.dimension, g.id, g.name) for g in ours.physical_groups] == [
        (g.dimension, g.id, g.name) for g in ref.physical_groups
    ]
    assert ours.group_lookup == ref.group_lookup
    for name in ("node_groups", "surface_groups"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert sorted(a) == sorted(b), name
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{name}[{key}]")


@pytest.mark.parametrize("path", [
    COLUMN_MSH, f"{REPO}/tests/data/cantilever.msh",
], ids=["column", "cantilever"])
def test_gmsh_files_parse_like_the_reference(path):
    from civiwave_tpu.mesh.gmsh import load_gmsh_file as jload

    assert_same_mesh(load_gmsh_file(path), jload(path, use_native=False))


@pytest.mark.parametrize("kind", ["tet", "hex", "shuffled", "mixed"])
def test_box_meshes_equal_the_reference(kind):
    assert_same_mesh(*mesh_pair(kind))


def test_shuffle_is_seeded_and_scrambles():
    from civiwave_tpu_torch.utils.synthetic import box_mesh, shuffle_mesh_nodes

    a = shuffle_mesh_nodes(box_mesh(3, 3, 3, hex_elements=True), seed=1)
    b = shuffle_mesh_nodes(box_mesh(3, 3, 3, hex_elements=True), seed=1)
    c = shuffle_mesh_nodes(box_mesh(3, 3, 3, hex_elements=True), seed=2)
    np.testing.assert_array_equal(a.elements, b.elements)
    assert not np.array_equal(a.elements, c.elements)


BROKEN_GMSH = {
    "no_nodes": "$MeshFormat\n4.1 0 8\n$EndMeshFormat\n",
    "node_count": "$Nodes\n1 3 1 3\n3 3 0 2\n1\n2\n0 0 0\n1 0 0\n$EndNodes\n"
                  "$Elements\n0 0 0 0\n$EndElements\n",
    "element_type": "$Nodes\n1 1 1 1\n3 3 0 1\n1\n0 0 0\n$EndNodes\n"
                    "$Elements\n1 1 1 1\n3 3 7 1\n1 1 1 1 1 1\n$EndElements\n",
    "unknown_node": "$Nodes\n1 1 1 1\n3 3 0 1\n1\n0 0 0\n$EndNodes\n"
                    "$Elements\n1 1 1 1\n3 3 4 1\n1 1 1 1 99\n$EndElements\n",
}


@pytest.mark.parametrize("case", sorted(BROKEN_GMSH))
def test_gmsh_errors_match_the_reference(case):
    text = BROKEN_GMSH[case]
    with pytest.raises(JCwfError) as ref:
        jload_string(text, use_native=False)
    with pytest.raises(MeshError) as ours:
        load_gmsh_from_string(text)
    assert str(ours.value) == str(ref.value)


def test_missing_gmsh_file_raises():
    with pytest.raises(MeshError, match="failed to open mesh file"):
        load_gmsh_file("/nonexistent/mesh.msh")


@pytest.mark.parametrize("kind", KINDS)
def test_preprocess_tables_match_the_reference(kind):
    (pm, jm), (pc, jc) = mesh_pair(kind), config_pair(kind)
    ours, ref = preprocess.run(pm, pc), jpreprocess.run(jm, jc)
    for name in (
        "element_volumes", "element_material_index", "tet_connectivity",
        "tet_gradients", "tet_volume", "tet_material", "tet_elements",
        "hex_connectivity", "hex_gradients_gp", "hex_detj", "hex_material",
        "hex_elements", "lumped_mass",
    ):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        scale = max(float(np.abs(b).max()), 1e-300) if b.size else 1.0
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * scale, err_msg=name)
    assert ours.hex_gradients_gp.dtype == np.float32  # stored f32
    adj, jadj = ours.adjacency, ref.adjacency
    for name in ("offsets", "row_indices", "local_indices"):
        np.testing.assert_array_equal(getattr(adj, name), getattr(jadj, name))


def _broken(kind):
    """(port mesh, JAX mesh, port cfg, JAX cfg) with one defect."""
    (pm, jm), (pc, jc) = mesh_pair("tet"), configs()
    for m in (pm, jm):
        if kind == "duplicate_node":
            m.node_positions[7] = m.node_positions[3]
        elif kind == "duplicate_element":
            m.elements[5] = m.elements[2]
        elif kind == "out_of_range":
            m.elements[4, 1] = m.node_count + 3
        elif kind == "degenerate_tet":
            m.elements[0, 3] = m.elements[0, 2]
            m.elements[0, 2] = m.elements[0, 1]
        elif kind == "no_elements":
            m.elements = m.elements[:0]
            m.element_node_counts = m.element_node_counts[:0]
            m.element_physical_group = m.element_physical_group[:0]
    if kind == "missing_group":
        pc, jc = configs(dirichlet={"fixes": [{"group": "NOPE", "dof": ["x"]}]})
    elif kind == "missing_point_group":
        pc, jc = configs(loads={
            "gravity": [0.0, 0.0, 0.0],
            "points": [{"group": "NOPE", "value": [1.0, 0.0, 0.0]}],
        })
    elif kind == "unassigned":
        pc, jc = configs(assignments=[{"group": "FIXED", "material": "steel"}])
    return pm, jm, pc, jc


@pytest.mark.parametrize("kind", [
    "duplicate_node", "duplicate_element", "out_of_range", "degenerate_tet",
    "no_elements", "missing_group", "missing_point_group", "unassigned",
])
def test_preprocess_errors_match_the_reference(kind):
    pm, jm, pc, jc = _broken(kind)
    with pytest.raises(JCwfError) as ref:
        jpreprocess.run(jm, jc)
    with pytest.raises(CwfError) as ours:
        preprocess.run(pm, pc)
    assert type(ours.value).__name__ == type(ref.value).__name__
    assert str(ours.value) == str(ref.value)


def test_inverted_hex_is_rejected():
    pm, _ = mesh_pair("hex")
    pm.elements[0] = pm.elements[0][[4, 5, 6, 7, 0, 1, 2, 3]]
    with pytest.raises(PreprocessError, match="hexahedron Jacobian non-positive"):
        preprocess.run(pm, configs()[0])


@pytest.mark.parametrize("kind", KINDS)
def test_rcm_permutation_and_spans_match_the_reference(kind):
    pm, _ = mesh_pair(kind)
    pre = preprocess.run(pm, config_pair(kind)[0])
    blocks = [pre.tet_connectivity[:, :4], pre.hex_connectivity]
    perm = renumber.plan_rcm(blocks, pm.node_count)
    np.testing.assert_array_equal(perm, jrenumber.plan_rcm(blocks, pm.node_count))
    assert renumber.element_spans(blocks, perm) == jrenumber.element_spans(
        blocks, perm
    )


@pytest.mark.parametrize("kind", KINDS)
def test_renumbering_decides_on_max_then_sum(kind):
    pm, _ = mesh_pair(kind)
    pre = preprocess.run(pm, config_pair(kind)[0])
    blocks = [pre.tet_connectivity[:, :4], pre.hex_connectivity]
    native = renumber.element_spans(blocks)
    rcm = renumber.element_spans(blocks, renumber.plan_rcm(blocks, pm.node_count))
    pair = renumber.plan_renumbering(blocks, pm.node_count)
    assert (pair is not None) == (rcm < native)
    if pair is not None:
        perm, inverse = pair
        np.testing.assert_array_equal(perm[inverse], np.arange(pm.node_count))
    if kind == "shuffled":
        assert pair is not None  # a scrambled numbering is always improved
