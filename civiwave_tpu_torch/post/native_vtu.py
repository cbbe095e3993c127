"""ctypes bridge to the native VTU writer (the repo's native/vtu_fast.cpp).

Port of :mod:`civiwave_tpu.post.native_vtu`.  Streams the appended-raw
blob straight from the numpy buffers to disk — at 50M-DOF scale the Python
path's blob assembly doubles the per-frame memory traffic.  The library is
built with g++ on first use into this package's ``_build/`` under its own
name (written to a temporary file, then renamed, so concurrent processes
never load a half-written library).  Byte-identical output; where g++ is
missing, the numpy writer of ``post/vtu.py`` writes the same bytes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PACKAGE_DIR), "native", "vtu_fast.cpp")
_BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libcwf_vtu_torch.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

_FLOATP = ctypes.POINTER(ctypes.c_float)


def _build_library() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.SubprocessError, OSError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def load_library() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            return None
        if not os.path.exists(_LIB_PATH) or os.path.getmtime(
            _LIB_PATH
        ) < os.path.getmtime(_SRC):
            if not os.path.isfile(_SRC) or not _build_library():
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _load_failed = True
            return None
        lib.cwf_write_vtu_padded.restype = ctypes.c_int32
        lib.cwf_write_vtu_padded.argtypes = [
            ctypes.c_char_p,  # path
            ctypes.c_int64,  # n_points
            ctypes.c_int64,  # n_cells
            _FLOATP,  # points
            ctypes.POINTER(ctypes.c_int32),  # padded elements (E, max_slots)
            ctypes.c_int32,  # max_slots
            ctypes.POINTER(ctypes.c_int32),  # element node counts (E,)
            ctypes.c_double,  # time
            ctypes.c_uint32,  # frame
            ctypes.c_int32,  # n point arrays
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(_FLOATP),
            ctypes.c_int32,  # n cell arrays
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(_FLOATP),
        ]
        lib.cwf_write_vtu_structured.restype = ctypes.c_int32
        lib.cwf_write_vtu_structured.argtypes = [
            ctypes.c_char_p,  # path
            ctypes.c_int32,  # nx (cells)
            ctypes.c_int32,  # ny
            ctypes.c_int32,  # nz
            _FLOATP,  # points
            ctypes.c_double,  # time
            ctypes.c_uint32,  # frame
            ctypes.c_int32,  # n point arrays
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(_FLOATP),
            ctypes.c_int32,  # n cell arrays
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(_FLOATP),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def _array_group(arrays: Sequence[Tuple[str, int, np.ndarray]]):
    names = (ctypes.c_char_p * len(arrays))(
        *[name.encode("ascii") for name, _, _ in arrays]
    )
    comps = (ctypes.c_int32 * len(arrays))(*[c for _, c, _ in arrays])
    ptrs = (_FLOATP * len(arrays))(
        *[a.ctypes.data_as(_FLOATP) for _, _, a in arrays]
    )
    return names, comps, ptrs


def write_vtu_structured_native(
    path: str,
    nx: int,
    ny: int,
    nz: int,
    points: np.ndarray,
    point_arrays: List[Tuple[str, int, np.ndarray]],
    cell_arrays: List[Tuple[str, int, np.ndarray]],
    simulation_time: float,
    frame_index: int,
) -> int:
    """Write one structured-box frame; connectivity is generated in C++
    (implicit in nx/ny/nz), so nothing cell-topology-sized touches Python.
    Returns the native status (0 = ok, -3 = Int32 offsets overflow)."""
    lib = load_library()
    assert lib is not None
    point_arrays = [
        (n, c, np.ascontiguousarray(a, dtype=np.float32))
        for n, c, a in point_arrays
    ]
    cell_arrays = [
        (n, c, np.ascontiguousarray(a, dtype=np.float32))
        for n, c, a in cell_arrays
    ]
    points = np.ascontiguousarray(points, dtype=np.float32)
    pa_names, pa_comps, pa_ptrs = _array_group(point_arrays)
    ca_names, ca_comps, ca_ptrs = _array_group(cell_arrays)
    return int(
        lib.cwf_write_vtu_structured(
            path.encode("utf-8"),
            int(nx),
            int(ny),
            int(nz),
            points.ctypes.data_as(_FLOATP),
            float(simulation_time),
            int(frame_index),
            len(point_arrays),
            pa_names,
            pa_comps,
            pa_ptrs,
            len(cell_arrays),
            ca_names,
            ca_comps,
            ca_ptrs,
        )
    )


def write_vtu_padded_native(
    path: str,
    points: np.ndarray,
    elements: np.ndarray,  # (E, max_slots) int32, -1 tail padding
    element_node_counts: np.ndarray,  # (E,) int32
    point_arrays: List[Tuple[str, int, np.ndarray]],
    cell_arrays: List[Tuple[str, int, np.ndarray]],
    simulation_time: float,
    frame_index: int,
) -> int:
    """Write one unstructured frame streaming connectivity/offsets/types
    straight from the resident padded element table — no VTU-layout cell
    arrays are ever materialized on the host (the ragged extraction +
    cumsum built ~600 MB of per-frame temporaries at 10M-DOF tet meshes).
    Returns the native status (0 = ok, -3 = Int32 offsets overflow)."""
    lib = load_library()
    assert lib is not None
    point_arrays = [
        (n, c, np.ascontiguousarray(a, dtype=np.float32))
        for n, c, a in point_arrays
    ]
    cell_arrays = [
        (n, c, np.ascontiguousarray(a, dtype=np.float32))
        for n, c, a in cell_arrays
    ]
    points = np.ascontiguousarray(points, dtype=np.float32)
    elements = np.ascontiguousarray(elements, dtype=np.int32)
    counts = np.ascontiguousarray(element_node_counts, dtype=np.int32)
    pa_names, pa_comps, pa_ptrs = _array_group(point_arrays)
    ca_names, ca_comps, ca_ptrs = _array_group(cell_arrays)
    return int(
        lib.cwf_write_vtu_padded(
            path.encode("utf-8"),
            points.shape[0],
            elements.shape[0],
            points.ctypes.data_as(_FLOATP),
            elements.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            elements.shape[1] if elements.ndim == 2 else 0,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            float(simulation_time),
            int(frame_index),
            len(point_arrays),
            pa_names,
            pa_comps,
            pa_ptrs,
            len(cell_arrays),
            ca_names,
            ca_comps,
            ca_ptrs,
        )
    )
