"""Vec3 helpers with the reference's exact semantics.

Copy of :mod:`civiwave_tpu.utils.vec3` (host numpy), a rebuild of the
reference engine's include/cwf/common/math.hpp (dot math.hpp:89, cross
math.hpp:124, magnitude, safe_normalize math.hpp:181-191).  Most of
the framework uses numpy directly; these exist for the places that need the
reference's *edge-case contract* — in particular ``safe_normalize`` returns
the zero vector (never NaN/inf) for inputs below 1e-12 or non-finite
magnitudes, which the interactive point-load path relies on.

All helpers accept array-likes of shape (..., 3) and vectorize.
"""

from __future__ import annotations

import numpy as np

_NORMALIZE_THRESHOLD = 1.0e-12  # math.hpp:183


def dot(a, b) -> np.ndarray:
    """Dot product over the trailing axis (math.hpp:89)."""
    return np.sum(np.asarray(a, np.float64) * np.asarray(b, np.float64), axis=-1)


def cross(a, b) -> np.ndarray:
    """Right-handed cross product (math.hpp:124)."""
    return np.cross(np.asarray(a, np.float64), np.asarray(b, np.float64))


def magnitude(a) -> np.ndarray:
    """Euclidean norm over the trailing axis."""
    return np.sqrt(dot(a, a))


def safe_normalize(a) -> np.ndarray:
    """Unit vector, or exact zero for degenerate/non-finite input
    (math.hpp:181-191: threshold 1e-12, isfinite guard)."""
    a = np.asarray(a, np.float64)
    mag = magnitude(a)
    bad = (mag < _NORMALIZE_THRESHOLD) | ~np.isfinite(mag)
    inv = 1.0 / np.where(bad, 1.0, mag)
    # mask the result, not just the scale: inf * 0.0 would still be NaN
    return np.where(bad[..., None], 0.0, a * inv[..., None])
