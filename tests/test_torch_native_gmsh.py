"""The port's native (g++) Gmsh parser against its Python parser and the
JAX package's loader: the cases of ``tests/test_native_gmsh.py``.

* a tet and a hex box written as Gmsh 4.1 text parse to the same arrays
  (node positions, elements, surfaces, groups) through the native parser,
  the port's Python parser and the JAX loader;
* malformed sections raise the same MeshError messages on both parsers;
* the native parse is not slower than the Python one (the reference's
  margin of 1.5x on a 20^3 hex box);
* asking for the native parser where it does not build raises instead of
  parsing in Python.

The native cases skip where g++ is missing, as the reference's do.
"""

import io
import time

import numpy as np
import pytest

from civiwave_tpu.mesh.gmsh import load_gmsh_from_string as jax_load
from civiwave_tpu_torch.mesh import native
from civiwave_tpu_torch.mesh.gmsh import load_gmsh_from_string
from civiwave_tpu_torch.utils.errors import MeshError
from civiwave_tpu_torch.utils.synthetic import box_mesh

needs_gxx = pytest.mark.skipif(
    not native.available(), reason="native parser unavailable (no g++)"
)


def mesh_to_gmsh_text(mesh) -> str:
    """Serialize a synthetic mesh to Gmsh 4.1 ASCII (one node block)."""
    out = io.StringIO()
    out.write("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n")
    out.write("$PhysicalNames\n3\n")
    out.write('2 1 "FIXED"\n2 2 "LOAD_FACE"\n3 3 "SOLID"\n$EndPhysicalNames\n')
    n = mesh.node_count
    out.write(f"$Nodes\n1 {n} 1 {n}\n")
    out.write(f"3 1 0 {n}\n")
    for i in range(n):
        out.write(f"{i + 1}\n")
    for pos in mesh.node_positions:
        out.write(f"{pos[0]} {pos[1]} {pos[2]}\n")
    out.write("$EndNodes\n")

    e = mesh.element_count
    s = len(mesh.surfaces)
    out.write(f"$Elements\n3 {e + s} 1 {e + s}\n")
    for group in (1, 2):
        members = np.nonzero(mesh.surface_physical_group == group)[0]
        out.write(f"2 {group} 3 {len(members)}\n")
        for idx in members:
            nodes = " ".join(str(v + 1) for v in mesh.surfaces[idx, :4])
            out.write(f"{idx + 1} {nodes}\n")
    gmsh_type = 5 if mesh.element_node_counts[0] == 8 else 4
    out.write(f"3 3 {gmsh_type} {e}\n")
    for idx in range(e):
        count = mesh.element_node_counts[idx]
        nodes = " ".join(str(v + 1) for v in mesh.elements[idx, :count])
        out.write(f"{s + idx + 1} {nodes}\n")
    out.write("$EndElements\n")
    return out.getvalue()


def _assert_same_mesh(a, b):
    for name in ("node_positions", "node_original_ids", "elements",
                 "element_node_counts", "element_physical_group",
                 "element_original_ids", "surfaces", "surface_node_counts",
                 "surface_physical_group", "surface_original_ids"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    for groups in ("surface_groups", "node_groups"):
        ga, gb = getattr(a, groups), getattr(b, groups)
        assert set(ga) == set(gb)
        for gid in ga:
            np.testing.assert_array_equal(ga[gid], gb[gid])
    assert [(g.dimension, g.id, g.name) for g in a.physical_groups] == [
        (g.dimension, g.id, g.name) for g in b.physical_groups]


@needs_gxx
@pytest.mark.parametrize("hex_elements", [False, True], ids=["tet", "hex"])
def test_native_matches_python_and_reference(hex_elements):
    text = mesh_to_gmsh_text(box_mesh(3, 2, 2, hex_elements=hex_elements))
    native.reset_counts()
    via_native = load_gmsh_from_string(text, use_native=True)
    assert native.parse_nodes_section.calls == 1
    assert native.parse_elements_section.calls == 1
    via_python = load_gmsh_from_string(text, use_native=False)
    assert native.parse_nodes_section.calls == 1
    _assert_same_mesh(via_native, via_python)
    _assert_same_mesh(via_native, jax_load(text, use_native=False))
    # the default is the reference's: native where it builds
    load_gmsh_from_string(text)
    assert native.parse_nodes_section.calls == 2


BAD_NODES = """$Nodes
1 2 1 2
3 1 0 1
1
0 0 0
$EndNodes
$Elements
0 0 0 0
$EndElements
"""

BAD_TYPE = """$Nodes
1 1 1 1
3 1 0 1
1
0 0 0
$EndNodes
$Elements
1 1 1 1
3 1 7 1
1 1 1 1 1
$EndElements
"""


@needs_gxx
@pytest.mark.parametrize("text, message", [
    (BAD_NODES, "node count mismatch"),
    (BAD_TYPE, "unsupported Gmsh element type 7"),
], ids=["nodes", "type"])
def test_native_error_messages_match(text, message):
    errors = []
    for use_native in (False, True):
        with pytest.raises(MeshError, match=message) as info:
            load_gmsh_from_string(text, use_native=use_native)
        errors.append((str(info.value), info.value.context))
    assert errors[0] == errors[1]
    with pytest.raises(Exception, match=message):
        jax_load(text, use_native=False)


@needs_gxx
def test_native_is_faster_on_large_mesh():
    text = mesh_to_gmsh_text(box_mesh(20, 20, 20, hex_elements=True))

    t0 = time.perf_counter()
    load_gmsh_from_string(text, use_native=False)
    python_time = time.perf_counter() - t0

    t0 = time.perf_counter()
    load_gmsh_from_string(text, use_native=True)
    native_time = time.perf_counter() - t0

    # the native path must not be slower; typically it is 10-50x faster
    assert native_time < python_time * 1.5


def test_asking_for_native_where_it_does_not_build_raises(monkeypatch):
    text = mesh_to_gmsh_text(box_mesh(1, 1, 1, hex_elements=True))
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(MeshError, match="native Gmsh parser unavailable"):
        load_gmsh_from_string(text, use_native=True)
    native.reset_counts()
    mesh = load_gmsh_from_string(text)  # the default parses in Python here
    assert mesh.element_count == 1
    assert native.parse_nodes_section.calls == 0
