"""Hex8 shape gradients (numpy).

Port of :mod:`civiwave_tpu.mesh.preprocess`, cut to the two functions the
structured route needs for its constant element tables
(``ops/structured.py`` ``_element_tables``): ``hex_gradients_gp_major`` and
its element-major view ``hex_gradients``.  2x2x2 Gauss with unit weights,
J = dN.x, grad = J^-1 dN (the reference's preprocess.cpp math).  Mesh
validation, lumped masses and adjacency wait for the general-path port
(ROADMAP A6).
"""

from __future__ import annotations

import numpy as np

# trilinear hex8 reference coordinates (Gmsh node ordering)
_HEX_XI = np.array(
    [
        [-1.0, -1.0, -1.0],
        [1.0, -1.0, -1.0],
        [1.0, 1.0, -1.0],
        [-1.0, 1.0, -1.0],
        [-1.0, -1.0, 1.0],
        [1.0, -1.0, 1.0],
        [1.0, 1.0, 1.0],
        [-1.0, 1.0, 1.0],
    ]
)
_GAUSS_1D = 1.0 / np.sqrt(3.0)


def _hex_gp_shape_gradients() -> np.ndarray:
    """dN/dxi at the 8 Gauss points: (8 gp, 8 node, 3) in reference coords."""
    gps = _HEX_XI * _GAUSS_1D  # 2x2x2 points share the corner pattern
    out = np.zeros((8, 8, 3))
    for g, (gx, gy, gz) in enumerate(gps):
        for l, (sx, sy, sz) in enumerate(_HEX_XI):
            out[g, l, 0] = 0.125 * sx * (1 + sy * gy) * (1 + sz * gz)
            out[g, l, 1] = 0.125 * sy * (1 + sx * gx) * (1 + sz * gz)
            out[g, l, 2] = 0.125 * sz * (1 + sx * gx) * (1 + sy * gy)
    return out


_HEX_DN = _hex_gp_shape_gradients()  # (8, 8, 3)


def hex_gradients_gp_major(positions: np.ndarray, dtype=np.float64) -> tuple:
    """Per-Gauss-point physical gradients + detJ in gp-major layout.

    positions: (H, 8, 3).  Returns (gradients (8gp, 8l, 3, H) ``dtype``,
    det (8gp, H) f64).  The Jacobian and its inverse are computed in f64
    with the closed-form adjugate on contiguous (H,) component streams.
    """
    h = positions.shape[0]
    dn_mat = np.ascontiguousarray(_HEX_DN.transpose(0, 2, 1))  # (8g, 3a, 8l)
    pos_t = positions.transpose(1, 2, 0).reshape(8, 3 * h)

    grads = np.empty((8, 8, 3, h), dtype)
    det = np.empty((8, h))
    dn = _HEX_DN.astype(dtype)
    # inv_t[a, b] = (J^-1)[b, a] per gp; assignments cast f64 -> dtype
    inv_t = np.empty((3, 3, h), dtype)
    jac_g = np.empty((3, 3 * h))
    for g in range(8):
        np.matmul(dn_mat[g], pos_t, out=jac_g)
        a = jac_g.reshape(3, 3, h)  # contiguous component streams
        i00 = a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1]
        i10 = a[1, 2] * a[2, 0] - a[1, 0] * a[2, 2]
        i20 = a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]
        d = a[0, 0] * i00 + a[0, 1] * i10 + a[0, 2] * i20
        det[g] = d
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_d = 1.0 / d
        inv_t[0, 0] = i00 * inv_d
        inv_t[0, 1] = i10 * inv_d
        inv_t[0, 2] = i20 * inv_d
        inv_t[1, 0] = (a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2]) * inv_d
        inv_t[1, 1] = (a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0]) * inv_d
        inv_t[1, 2] = (a[0, 1] * a[2, 0] - a[0, 0] * a[2, 1]) * inv_d
        inv_t[2, 0] = (a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]) * inv_d
        inv_t[2, 1] = (a[0, 2] * a[1, 0] - a[0, 0] * a[1, 2]) * inv_d
        inv_t[2, 2] = (a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]) * inv_d
        # grad[l, b] = sum_a dN[g, l, a] (J^-1)[b, a] = dN[g] @ inv_t
        grads[g] = (dn[g] @ inv_t.reshape(3, 3 * h)).reshape(8, 3, h)
    return grads, det


def hex_gradients(positions: np.ndarray) -> tuple:
    """Element-major view of :func:`hex_gradients_gp_major`.

    positions: (H, 8, 3).  Returns (gradients (H, 8gp, 8node, 3),
    point_volume (H, 8gp)).
    """
    grads, det = hex_gradients_gp_major(positions)
    return grads.transpose(3, 0, 1, 2), det.T
