"""Gmsh 4.1 ASCII mesh parser.

Port of :mod:`civiwave_tpu.mesh.gmsh`, a behavior-compatible rebuild of
the reference engine's parser (src/mesh/mesh.cpp:434-566).  The bulk
``$Nodes``/``$Elements`` sections go through the g++ parser
(``mesh/native.py``) or the Python parser below, its plain version, by
``use_native``: None (the default, the reference's) takes the native
parser where it builds and Python elsewhere; True takes the native parser
and raises MeshError where it does not build; False takes Python.  Both
give the same arrays and the same MeshError messages.

* sections parsed: ``$PhysicalNames`` (mesh.cpp:68-94), ``$Entities``
  (mesh.cpp:96-158), ``$Nodes`` (mesh.cpp:160-232), ``$Elements``
  (mesh.cpp:277-413); everything else is skipped.
* supported element types: 2 = tri3, 3 = quad4 (surfaces), 4 = tet4,
  5 = hex8 (volumes); dim 0/1 entities are consumed silently
  (mesh.cpp:396-404).
* an element's physical group id is the first physical tag of its owning
  entity, falling back to the entity tag itself (mesh.cpp:311-317).
* nodes inherit the physical groups of their entity block into
  ``node_groups`` (mesh.cpp:216-224) — this is how dim-0 point-load groups
  reach the load assembler.
* errors carry the same messages the reference emits ("node count mismatch",
  "unsupported Gmsh element type {}", "element references unknown node {}",
  "missing $Nodes section", ...).

Implementation detail: instead of the reference's line-by-line istream walk,
each section is tokenized once and consumed through a cursor — same grammar,
far faster in Python for large meshes (numpy bulk conversion of node/element
blocks).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..utils.errors import MeshError
from .model import Mesh, PhysicalGroup, SENTINEL

_VOLUME_TYPES = {4: 4, 5: 8}  # gmsh type -> node count (tet4, hex8)
_SURFACE_TYPES = {2: 3, 3: 4}  # tri3, quad4
_NODE_COUNTS = {2: 3, 3: 4, 4: 4, 5: 8}  # mesh.cpp:234-249


def load_gmsh_file(path: str, use_native=None) -> Mesh:
    """Read and parse a Gmsh 4.1 ASCII file (mesh.cpp:434-445)."""
    try:
        with open(path, "r", encoding="utf-8") as handle:
            contents = handle.read()
    except OSError:
        raise MeshError(f"failed to open mesh file: {path}", [str(path)]) from None
    return load_gmsh_from_string(contents, use_native=use_native)


def _use_native(use_native) -> bool:
    """Whether the bulk sections go through the native parser: where it
    builds for None, always for True (MeshError where it does not build:
    no quiet fallback to a parser the caller did not ask for), never for
    False."""
    from . import native as native_mod

    if use_native is None:
        return native_mod.available()
    if use_native and not native_mod.available():
        raise MeshError(
            "native Gmsh parser unavailable: g++ could not build "
            "native/gmsh_fast.cpp", [native_mod.LIB_PATH])
    return bool(use_native)


def _split_sections(contents: str) -> Dict[str, List[str]]:
    """Collect section-name -> token list for each $Section...$EndSection."""
    sections: Dict[str, List[str]] = {}
    lines = contents.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("$") and not line.startswith("$End"):
            name = line[1:]
            body: List[str] = []
            i += 1
            end_marker = f"$End{name}"
            while i < len(lines) and lines[i].strip() != end_marker:
                body.append(lines[i])
                i += 1
            sections[name] = body
        i += 1
    return sections


def _parse_physical_names(body: List[str]) -> Dict[Tuple[int, int], str]:
    """(dimension, tag) -> name (mesh.cpp:68-94)."""
    names: Dict[Tuple[int, int], str] = {}
    if not body:
        return names
    count = int(body[0].split()[0])
    for i in range(count):
        if i + 1 >= len(body):
            raise MeshError("unexpected EOF in $PhysicalNames", ["PhysicalNames"])
        parts = body[i + 1].split(None, 2)
        dim, tag = int(parts[0]), int(parts[1])
        name = parts[2].strip() if len(parts) > 2 else ""
        if len(name) >= 2 and name[0] == '"' and name[-1] == '"':
            name = name[1:-1]
        names[(dim, tag)] = name
    return names


class _Entities:
    """Entity -> physical-group mapping (mesh.cpp:96-158)."""

    def __init__(self) -> None:
        self.physical_mapping: Dict[Tuple[int, int], List[int]] = {}
        self.physical_dimensions: Dict[int, int] = {}


def _parse_entities(body: List[str]) -> _Entities:
    info = _Entities()
    tokens = " ".join(body).split()
    if not tokens:
        raise MeshError("unexpected EOF in $Entities header", ["Entities"])
    cursor = 0

    def take(n: int) -> List[str]:
        nonlocal cursor
        if cursor + n > len(tokens):
            raise MeshError("unexpected EOF inside $Entities block", ["Entities"])
        out = tokens[cursor : cursor + n]
        cursor += n
        return out

    counts = [int(x) for x in take(4)]
    for dimension, count in enumerate(counts):
        for _ in range(count):
            tag = int(take(1)[0])
            # points have 3 coords; curves/surfaces/volumes have a 6-float bbox
            take(3 if dimension == 0 else 6)
            num_phys = int(take(1)[0])
            phys_ids = [int(x) for x in take(num_phys)]
            for phys in phys_ids:
                info.physical_dimensions.setdefault(phys, dimension)
            if phys_ids:
                info.physical_mapping[(dimension, tag)] = phys_ids
            if dimension >= 1:
                # bounding entity tags (curves for surfaces, etc.)
                num_bounding = int(take(1)[0])
                take(num_bounding)
    return info


def _parse_nodes(body: List[str], entities: _Entities, use_native=None):
    from . import native as native_mod

    nodes_by_group: Dict[int, List[np.ndarray]] = {}

    if _use_native(use_native):
        try:
            ids, coords, blocks = native_mod.parse_nodes_section(
                "\n".join(body).encode()
            )
        except ValueError as exc:
            raise MeshError(str(exc), ["Nodes"]) from None
        for entity_dim, entity_tag, first, count in blocks:
            phys_ids = entities.physical_mapping.get(
                (int(entity_dim), int(entity_tag))
            )
            if phys_ids:
                indices = np.arange(first, first + count, dtype=np.int64)
                for phys in phys_ids:
                    nodes_by_group.setdefault(phys, []).append(indices)
    else:
        tokens = " ".join(body).split()
        if not tokens:
            raise MeshError("unexpected EOF in $Nodes header", ["Nodes"])
        cursor = 0

        def take(n: int) -> List[str]:
            nonlocal cursor
            if cursor + n > len(tokens):
                raise MeshError("unexpected EOF reading node data", ["Nodes"])
            out = tokens[cursor : cursor + n]
            cursor += n
            return out

        num_blocks, num_nodes, _min_node, _max_node = (int(x) for x in take(4))

        all_ids: List[np.ndarray] = []
        all_coords: List[np.ndarray] = []
        running = 0

        for _ in range(num_blocks):
            entity_dim, entity_tag, _parametric, nodes_in_block = (
                int(x) for x in take(4)
            )
            ids = np.array([int(x) for x in take(nodes_in_block)], dtype=np.int64)
            coords = np.array(
                [float(x) for x in take(nodes_in_block * 3)], dtype=np.float64
            ).reshape(nodes_in_block, 3)
            all_ids.append(ids)
            all_coords.append(coords)
            phys_ids = entities.physical_mapping.get((entity_dim, entity_tag))
            if phys_ids:
                indices = np.arange(running, running + nodes_in_block, dtype=np.int64)
                for phys in phys_ids:
                    nodes_by_group.setdefault(phys, []).append(indices)
            running += nodes_in_block

        if running != num_nodes:
            raise MeshError("node count mismatch", ["Nodes"])

        ids = np.concatenate(all_ids) if all_ids else np.zeros((0,), np.int64)
        coords = (
            np.concatenate(all_coords) if all_coords else np.zeros((0, 3), np.float64)
        )

    id_to_index = {int(original): idx for idx, original in enumerate(ids)}
    node_groups = {
        phys: np.concatenate(chunks) for phys, chunks in nodes_by_group.items()
    }
    return ids, coords, id_to_index, node_groups


def _element_blocks_python(body: List[str]):
    """Yield (dim, tag, etype, tags, raw_nodes) per block from tokenized
    text, consuming skipped dims silently; final yield is the processed
    count (mesh.cpp:293-405 semantics)."""
    tokens = " ".join(body).split()
    if not tokens:
        raise MeshError("unexpected EOF in $Elements header", ["Elements"])
    cursor = 0

    def take(n: int) -> List[str]:
        nonlocal cursor
        if cursor + n > len(tokens):
            raise MeshError("unexpected EOF reading element data", ["Elements"])
        out = tokens[cursor : cursor + n]
        cursor += n
        return out

    num_blocks, num_elements, _min_tag, _max_tag = (int(x) for x in take(4))
    processed = 0
    blocks = []
    for _ in range(num_blocks):
        entity_dim, entity_tag, element_type, elements_in_block = (
            int(x) for x in take(4)
        )
        node_count = _NODE_COUNTS.get(element_type)
        if node_count is None:
            raise MeshError(
                f"unsupported Gmsh element type {element_type}",
                ["Elements", f"entityTag={entity_tag}"],
            )
        rows = np.array(
            [int(x) for x in take(elements_in_block * (1 + node_count))],
            dtype=np.int64,
        ).reshape(elements_in_block, 1 + node_count)
        processed += elements_in_block
        if entity_dim in (2, 3):
            blocks.append(
                (entity_dim, entity_tag, element_type, rows[:, 0], rows[:, 1:])
            )
    if processed != num_elements:
        raise MeshError("element count mismatch", ["Elements"])
    return blocks


def _element_blocks_native(body: List[str]):
    """Same contract as :func:`_element_blocks_python` via the C++ parser."""
    from . import native as native_mod

    try:
        raw_blocks, tags, conn = native_mod.parse_elements_section(
            "\n".join(body).encode()
        )
    except ValueError as exc:
        message = str(exc)
        if "|" in message:
            message, ctx = message.split("|", 1)
            raise MeshError(message, ["Elements", ctx]) from None
        raise MeshError(message, ["Elements"]) from None

    blocks = []
    conn_cursor = 0
    for dim, tag, etype, first, count in raw_blocks:
        node_count = _NODE_COUNTS[int(etype)]
        block_tags = tags[first : first + count]
        raw_nodes = conn[conn_cursor : conn_cursor + count * node_count].reshape(
            count, node_count
        )
        conn_cursor += count * node_count
        blocks.append((int(dim), int(tag), int(etype), block_tags, raw_nodes))
    return blocks


def _parse_elements(
    body: List[str],
    id_to_index: Dict[int, int],
    entities: _Entities,
    use_native=None,
):
    if _use_native(use_native):
        block_list = _element_blocks_native(body)
    else:
        block_list = _element_blocks_python(body)

    vol_conn: List[np.ndarray] = []
    vol_counts: List[np.ndarray] = []
    vol_groups: List[np.ndarray] = []
    vol_ids: List[np.ndarray] = []
    surf_conn: List[np.ndarray] = []
    surf_counts: List[np.ndarray] = []
    surf_groups: List[np.ndarray] = []
    surf_ids: List[np.ndarray] = []
    surface_groups: Dict[int, List[np.ndarray]] = {}
    used_physical_ids = set()
    surface_running = 0

    # id remap table for vectorized lookup
    if id_to_index:
        max_id = max(id_to_index)
        remap = np.full(max_id + 2, -1, dtype=np.int64)
        for original, idx in id_to_index.items():
            remap[original] = idx
    else:
        remap = np.full(2, -1, dtype=np.int64)

    for entity_dim, entity_tag, element_type, tags, raw_nodes in block_list:
        node_count = _NODE_COUNTS[element_type]
        elements_in_block = len(tags)
        phys_ids = entities.physical_mapping.get((entity_dim, entity_tag))
        physical_group_id = phys_ids[0] if phys_ids else entity_tag

        if entity_dim == 3:
            if element_type not in _VOLUME_TYPES:
                raise MeshError(
                    f"unsupported volume element type {element_type}",
                    ["Elements", f"elementTag={int(tags[0]) if len(tags) else entity_tag}"],
                )
        elif entity_dim == 2:
            if element_type not in _SURFACE_TYPES:
                raise MeshError(
                    f"unsupported surface element type {element_type}",
                    ["Elements", f"elementTag={int(tags[0]) if len(tags) else entity_tag}"],
                )
        else:  # pragma: no cover — block producers already skip other dims
            continue

        out_of_range = (raw_nodes < 0) | (raw_nodes >= remap.shape[0])
        mapped = remap[np.clip(raw_nodes, 0, remap.shape[0] - 1)]
        bad = out_of_range | (mapped < 0)
        if bad.any():
            row, col = np.argwhere(bad)[0]
            kind = "element" if entity_dim == 3 else "surface"
            raise MeshError(
                f"{kind} references unknown node {int(raw_nodes[row, col])}",
                ["Elements", f"elementTag={int(tags[row])}"],
            )

        used_physical_ids.add(physical_group_id)
        if entity_dim == 3:
            padded = np.full((elements_in_block, 8), SENTINEL, dtype=np.int32)
            padded[:, :node_count] = mapped.astype(np.int32)
            vol_conn.append(padded)
            vol_counts.append(np.full(elements_in_block, node_count, np.int32))
            vol_groups.append(np.full(elements_in_block, physical_group_id, np.int64))
            vol_ids.append(tags)
        else:
            padded = np.full((elements_in_block, 4), SENTINEL, dtype=np.int32)
            padded[:, :node_count] = mapped.astype(np.int32)
            surf_conn.append(padded)
            surf_counts.append(np.full(elements_in_block, node_count, np.int32))
            surf_groups.append(np.full(elements_in_block, physical_group_id, np.int64))
            surf_ids.append(tags)
            indices = np.arange(
                surface_running, surface_running + elements_in_block, dtype=np.int64
            )
            surface_groups.setdefault(physical_group_id, []).append(indices)
            surface_running += elements_in_block

    def cat(parts, empty):
        return np.concatenate(parts) if parts else empty

    return (
        cat(vol_conn, np.zeros((0, 8), np.int32)),
        cat(vol_counts, np.zeros((0,), np.int32)),
        cat(vol_groups, np.zeros((0,), np.int64)),
        cat(vol_ids, np.zeros((0,), np.int64)),
        cat(surf_conn, np.zeros((0, 4), np.int32)),
        cat(surf_counts, np.zeros((0,), np.int32)),
        cat(surf_groups, np.zeros((0,), np.int64)),
        cat(surf_ids, np.zeros((0,), np.int64)),
        {phys: np.concatenate(chunks) for phys, chunks in surface_groups.items()},
        used_physical_ids,
    )


def load_gmsh_from_string(contents: str, use_native=None) -> Mesh:
    """Parse Gmsh 4.1 ASCII contents into a :class:`Mesh` (mesh.cpp:447-566)."""
    use_native = _use_native(use_native)
    sections = _split_sections(contents)

    physical_names = (
        _parse_physical_names(sections["PhysicalNames"])
        if "PhysicalNames" in sections
        else {}
    )
    entities = _parse_entities(sections["Entities"]) if "Entities" in sections else _Entities()

    if "Nodes" not in sections:
        raise MeshError("missing $Nodes section", [])
    node_ids, coords, id_to_index, node_groups = _parse_nodes(
        sections["Nodes"], entities, use_native=use_native
    )

    if "Elements" not in sections:
        raise MeshError("missing $Elements section", [])
    (
        vol_conn,
        vol_counts,
        vol_groups,
        vol_ids,
        surf_conn,
        surf_counts,
        surf_groups_arr,
        surf_ids,
        surface_groups,
        used_physical_ids,
    ) = _parse_elements(
        sections["Elements"], id_to_index, entities, use_native=use_native
    )

    mesh = Mesh(
        node_positions=coords,
        node_original_ids=node_ids,
        elements=vol_conn,
        element_node_counts=vol_counts,
        element_physical_group=vol_groups,
        element_original_ids=vol_ids,
        surfaces=surf_conn,
        surface_node_counts=surf_counts,
        surface_physical_group=surf_groups_arr,
        surface_original_ids=surf_ids,
        node_groups=node_groups,
        surface_groups=surface_groups,
    )

    # physical group registry (mesh.cpp:525-563): names first, then dims from
    # entities, then referenced ids that never got a name.
    group_map: Dict[int, PhysicalGroup] = {}
    for (dimension, tag), name in physical_names.items():
        group_map[tag] = PhysicalGroup(dimension, tag, name)
    for phys_id, dimension in entities.physical_dimensions.items():
        if phys_id in group_map:
            group_map[phys_id] = PhysicalGroup(
                dimension, phys_id, group_map[phys_id].name
            )
        else:
            group_map[phys_id] = PhysicalGroup(dimension, phys_id, "")
    referenced = set(node_groups) | used_physical_ids
    for group_id in referenced:
        if group_id not in group_map:
            dimension = entities.physical_dimensions.get(group_id, 0)
            group_map[group_id] = PhysicalGroup(dimension, group_id, "")

    for group_id, group in group_map.items():
        mesh.group_lookup[group_id] = len(mesh.physical_groups)
        mesh.physical_groups.append(group)

    return mesh
