"""ctypes bridge to the native Gmsh section parser (the repo's
native/gmsh_fast.cpp).

Port of :mod:`civiwave_tpu.mesh.native`.  The C++ library scans the bulk
``$Nodes``/``$Elements`` numbers (the IO hot path at multi-million-node
scale; tokenizing in Python is far slower); ``$PhysicalNames`` and
``$Entities`` stay in Python (``mesh/gmsh.py``).  The library is built
with g++ on first use into this package's ``_build/`` under its own name
(written to a temporary file, then renamed, so concurrent processes never
load a half-written library), as ``post/native_vtu.py`` builds the VTU
writer.  Where g++ or the source is missing, :func:`available` is False:
``mesh.gmsh`` then parses in Python when the caller left the choice open
and raises when the caller asked for this parser.

``parse_nodes_section.calls`` and ``parse_elements_section.calls`` count
the sections parsed here (:func:`reset_counts` zeroes them), so a caller
can show that the native parse ran.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PACKAGE_DIR), "native", "gmsh_fast.cpp")
_BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
LIB_PATH = os.path.join(_BUILD_DIR, "libcwf_gmsh_torch.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


class _GmshNodes(ctypes.Structure):
    _fields_ = [
        ("count", ctypes.c_int64),
        ("block_count", ctypes.c_int64),
        ("ids", ctypes.POINTER(ctypes.c_int64)),
        ("coords", ctypes.POINTER(ctypes.c_double)),
        ("blocks", ctypes.POINTER(ctypes.c_int64)),
        ("status", ctypes.c_int32),
    ]


class _GmshElements(ctypes.Structure):
    _fields_ = [
        ("block_count", ctypes.c_int64),
        ("total_count", ctypes.c_int64),
        ("blocks", ctypes.POINTER(ctypes.c_int64)),
        ("tags", ctypes.POINTER(ctypes.c_int64)),
        ("conn", ctypes.POINTER(ctypes.c_int64)),
        ("conn_len", ctypes.c_int64),
        ("processed", ctypes.c_int64),
        ("status", ctypes.c_int32),
        ("bad_type", ctypes.c_int64),
        ("bad_entity", ctypes.c_int64),
    ]


def build_library() -> bool:
    """Build the library with g++ now (replacing a built one); False where
    g++ or the source is missing or the build fails."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIB_PATH)
        return True
    except (subprocess.SubprocessError, OSError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native parser; None when unavailable."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            return None
        if not os.path.exists(LIB_PATH) or os.path.getmtime(
            LIB_PATH
        ) < os.path.getmtime(_SRC):
            if not os.path.isfile(_SRC) or not build_library():
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(LIB_PATH)
        except OSError:
            _load_failed = True
            return None
        lib.cwf_parse_nodes.restype = ctypes.POINTER(_GmshNodes)
        lib.cwf_parse_nodes.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.cwf_parse_elements.restype = ctypes.POINTER(_GmshElements)
        lib.cwf_parse_elements.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.cwf_free_nodes.argtypes = [ctypes.POINTER(_GmshNodes)]
        lib.cwf_free_elements.argtypes = [ctypes.POINTER(_GmshElements)]
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def parse_nodes_section(body: bytes):
    """Parse a $Nodes body; returns (ids, coords, blocks) numpy arrays.

    blocks: (B, 4) int64 rows of (entity_dim, entity_tag, first, count).
    Raises ValueError with the reference's message on count mismatch.
    """
    lib = load_library()
    assert lib is not None
    parse_nodes_section.calls += 1
    handle = lib.cwf_parse_nodes(body, len(body))
    try:
        data = handle.contents
        if data.status == -15:
            raise ValueError("node count mismatch")
        if data.status != 0:
            raise ValueError(f"malformed $Nodes section (code {data.status})")
        n = data.count
        ids = np.ctypeslib.as_array(data.ids, shape=(n,)).copy()
        coords = np.ctypeslib.as_array(data.coords, shape=(n, 3)).copy()
        blocks = np.ctypeslib.as_array(
            data.blocks, shape=(data.block_count, 4)
        ).copy()
        return ids, coords, blocks
    finally:
        lib.cwf_free_nodes(handle)


def parse_elements_section(body: bytes):
    """Parse an $Elements body; returns (blocks, tags, conn) numpy arrays.

    blocks: (B, 5) int64 rows of (dim, entity_tag, element_type, first,
    count) for kept (dim 2/3) blocks; conn is the ragged concatenated
    connectivity.  Raises ValueError mirroring the reference's messages.
    """
    lib = load_library()
    assert lib is not None
    parse_elements_section.calls += 1
    handle = lib.cwf_parse_elements(body, len(body))
    try:
        data = handle.contents
        if data.status == -1:
            raise ValueError(
                f"unsupported Gmsh element type {data.bad_type}"
                f"|entityTag={data.bad_entity}"
            )
        if data.status == -24:
            raise ValueError("element count mismatch")
        if data.status != 0:
            raise ValueError(f"malformed $Elements section (code {data.status})")
        blocks = np.ctypeslib.as_array(
            data.blocks, shape=(data.block_count, 5)
        ).copy()
        tags = np.ctypeslib.as_array(data.tags, shape=(data.total_count,)).copy()
        conn = np.ctypeslib.as_array(data.conn, shape=(data.conn_len,)).copy()
        return blocks, tags, conn
    finally:
        lib.cwf_free_elements(handle)


def reset_counts() -> None:
    parse_nodes_section.calls = 0
    parse_elements_section.calls = 0


reset_counts()
