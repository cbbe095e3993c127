"""Headless visualization: deformed-mesh snapshots colored by von Mises.

Copy of :mod:`civiwave_tpu.post.snapshot`.  The reference engine ships an
interactive GLFW/ImGui/Vulkan viewer (src/ui/viewer.cpp — deformation
magnification, von Mises color ramp, wireframe) behind BUILD_UI; this
package is headless, and this module renders the same payload — deformed
surface triangles colored by the nodal von Mises field, with a deformation
scale factor — to PNG via matplotlib (imported at call time), for CI
artifacts and notebooks.  Interactive
exploration is delegated to ParaView via the VTU output.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..mesh.model import Mesh, SENTINEL
from .derived import DerivedFieldSet


# local face corner indices per element type (outward ordering irrelevant
# for unlit surface plots)
_TET_FACES = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]])
_HEX_FACES = np.array(
    [
        [0, 1, 2, 3],
        [4, 5, 6, 7],
        [0, 1, 5, 4],
        [3, 2, 6, 7],
        [0, 3, 7, 4],
        [1, 2, 6, 5],
    ]
)


def _boundary_faces(mesh: Mesh) -> np.ndarray:
    """Hull triangles from the volume elements: element faces that appear
    exactly once are on the boundary (vectorized sorted-key counting)."""
    faces = []
    counts = mesh.element_node_counts
    for nodes_per, table in ((4, _TET_FACES), (8, _HEX_FACES)):
        elems = mesh.elements[counts == nodes_per]
        if elems.size:
            faces.append(elems[:, table].reshape(-1, table.shape[1]))
    tris = []
    for group in faces:
        key = np.sort(group, axis=1)
        _, inverse, cnt = np.unique(
            key, axis=0, return_inverse=True, return_counts=True
        )
        boundary = group[cnt[inverse] == 1]
        if boundary.shape[1] == 3:
            tris.append(boundary)
        else:
            tris.append(boundary[:, [0, 1, 2]])
            tris.append(boundary[:, [0, 2, 3]])
    if not tris:
        return np.zeros((0, 3), np.int64)
    return np.concatenate(tris).astype(np.int64)


def _surface_triangles(mesh: Mesh) -> np.ndarray:
    """Hull triangles: extracted from the volume elements (faces used by
    exactly one element), falling back to tagged surface groups for
    surface-only meshes."""
    tris = _boundary_faces(mesh)
    if tris.size:
        return tris
    out = []
    for idx in range(len(mesh.surfaces)):
        conn = mesh.surfaces[idx]
        if mesh.surface_node_counts[idx] == 3:
            out.append(conn[:3])
        else:
            out.append(conn[[0, 1, 2]])
            out.append(conn[[0, 2, 3]])
    return (
        np.asarray(out, dtype=np.int64) if out else np.zeros((0, 3), np.int64)
    )


def save_snapshot(
    path: str,
    mesh: Mesh,
    displacement: np.ndarray,
    derived: Optional[DerivedFieldSet] = None,
    deformation_scale: float = 1.0,
    title: Optional[str] = None,
    elev: float = 20.0,
    azim: float = -60.0,
) -> None:
    """Render a deformed, von-Mises-colored snapshot to ``path`` (PNG)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    n = mesh.node_count
    points = mesh.node_positions + deformation_scale * np.asarray(displacement)[:n]
    tris = _surface_triangles(mesh)

    fig = plt.figure(figsize=(8, 6), dpi=120)
    ax = fig.add_subplot(projection="3d")

    vm = (
        derived.node_von_mises
        if derived is not None
        else np.zeros(n, dtype=np.float32)
    )
    face_vm = vm[tris].mean(axis=1)
    vmax = float(face_vm.max()) or 1.0
    colors = cm.viridis(face_vm / vmax)

    polys = Poly3DCollection(
        points[tris], facecolors=colors, edgecolor="k", linewidths=0.1
    )
    ax.add_collection3d(polys)

    lo = points.min(axis=0)
    hi = points.max(axis=0)
    center = (lo + hi) / 2
    radius = float((hi - lo).max()) / 2 or 1.0
    ax.set_xlim(center[0] - radius, center[0] + radius)
    ax.set_ylim(center[1] - radius, center[1] + radius)
    ax.set_zlim(center[2] - radius, center[2] + radius)
    ax.view_init(elev=elev, azim=azim)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    if title:
        ax.set_title(title)

    mappable = cm.ScalarMappable(cmap=cm.viridis)
    mappable.set_array(face_vm)
    fig.colorbar(mappable, ax=ax, shrink=0.6, label="von Mises [Pa]")

    import os

    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
