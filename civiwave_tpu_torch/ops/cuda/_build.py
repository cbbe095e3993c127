"""Build the CUDA kernels under ``civiwave_tpu_torch/csrc`` and bind them.

The ``.cu`` sources expose a plain C interface.  At first use each source
is compiled to an object by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library under
``civiwave_tpu_torch/_build/`` (listed in ``.gitignore``), loaded with
``ctypes``.  The library's name carries a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one is reused within
a checkout.  Nothing here runs at import time: the CPU tests import every
module on hosts without ``nvcc``.  Every wrapper launches through
:meth:`KernelLibrary.call`, which holds the device guard, the stream
argument, the error check and ``utils.profiling.launch``: an operator range
of the C entry's name while a trace has the program's ranges open, so that
the profiler counts the kernels in the ranges around them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ...utils import profiling

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_L = ctypes.c_longlong

# C entry points and their argument types (each returns the cudaError_t
# of its launch as an int).  An ``_f64`` entry is the f64 instance of the
# kernel above it: the same arguments with f64 vectors, ss and mf as
# doubles (K1/K5 also takes its taps as host doubles)
_SIGNATURES = {
    # pc_table, r, bc, z, X, Y, Z, nx, ny, nz, x0, y0, stream
    "civi_block_jacobi_apply": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "civi_block_jacobi_apply_f64": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # (K2 and K6 take their plane_sweep.SWEEP_TAPS taps in host memory,
    # then after the scalars the plane-sweep geometry: tile_y, tile_z,
    # chunk, grid_x, grid_y, grid_z, smem, and vec: 16-byte copies)
    # pc_table, stencil, taps, r, bc, u, w, partials, X, Y, Z, nx, ny, nz,
    # ss, mf, m8, geometry, stream
    "civi_pc_keff_structured": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F,
        _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # pc_table, stencil, taps, alpha_beta, x, r, u, w, p, s, bc, r_out,
    # w_out, s_out, partials, X, Y, Z, nx, ny, nz, ss, mf, m8, geometry,
    # stream
    "civi_pcg_iteration_structured": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _F, _F, _F,
        _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # x, bc, conn, grads, vol, lam, mu, rows, E, ss, stream
    "civi_element_forces_tet": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _P),
    "civi_element_forces_hex": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _P),
    "civi_element_forces_tet_f64": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _D, _P),
    "civi_element_forces_hex_f64": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _D, _P),
    # rows, csr_idx, csr_weight, mass, x, bc, out, N, D, mf, threads,
    # blocks, row_chunks, smem, stream
    "civi_assemble_csr": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _P,
    ),
    "civi_assemble_csr_f64": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _D, _I, _I, _I, _I, _P,
    ),
    # xs, taps (243 host floats), out, X, Y, Z, geometry (tile_y, tile_z,
    # chunk, grid_x, grid_y, grid_z, smem), vec, stream
    "civi_interior_stencil": (
        _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # interior, x, bc, codes, rows, ztaps (162 host floats), out, X, Y, Z,
    # nx, ny, nz, ss, mf, m8, geometry (x_planes, y_rows, xy_nodes,
    # xy_blocks, slabs, slab_envelope, slab_z, vec), stream
    "civi_keff_boundary": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F,
        _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # (K1 and K5) x, bc, gx_lo, bgx_lo, gx_hi, bgx_hi, gy_lo, bgy_lo, gy_hi,
    # bgy_hi, stencil, taps, out, Xl, Yl, Z, ghost_y, x0, y0, nx, ny, nz, p0,
    # p1, ss, mf, m8, geometry, vec, stream
    "civi_keff_structured_halo": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F,
        _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "civi_keff_structured_halo_f64": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _D, _D, _F,
        _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # (G3) x, bc, gx_lo, bgx_lo, gx_hi, bgx_hi, gy_lo, bgy_lo, gy_hi, bgy_hi,
    # lam, mu, lam_gx, mu_gx, lam_gy, mu_gy, mass, tables (1,152 host
    # values of the vector type), out, X, Y, Z, ghost_y, x0, y0, nx, ny, nz,
    # cell_y, p0, p1, ss, mf, geometry (tile_y, tile_z, chunk, grid_x,
    # grid_y, grid_z, threads, smem), stream
    "civi_corner_gather": (
        *(_P,) * 19, *(_I,) * 12, _F, _F, *(_I,) * 8, _P,
    ),
    "civi_corner_gather_f64": (
        *(_P,) * 19, *(_I,) * 12, _D, _D, *(_I,) * 8, _P,
    ),
    # x, r, p, s (updated in place), u, w, bc, alpha, beta (0-d device
    # scalars; beta NULL on a solve's first call), scalars_f64, n, stream
    "civi_cg_direction_update": (*(_P,) * 9, _I, _L, _P),
    "civi_cg_direction_update_f64": (*(_P,) * 9, _I, _L, _P),
    # (the stepper's passes: nodes, then plane, the grid's nodes per
    # component plane or 0 for node rows)
    # u, v, a, f, mass, u_pred, d, rhs, dt, c_pred, a0, a2, a3, a1, a4, a5,
    # alpha_r (f32 in both instances), nodes, plane, stream
    "civi_newmark_rhs": (*(_P,) * 8, *(_F,) * 9, _L, _L, _P),
    "civi_newmark_rhs_f64": (*(_P,) * 8, *(_D,) * 8, _F, _L, _L, _P),
    # rhs (in place), Kd, absorbing term (each NULL where absent), bc,
    # bc_value, beta_r, nodes, plane, stream
    "civi_newmark_rhs_clamp": (*(_P,) * 5, _F, _L, _L, _P),
    "civi_newmark_rhs_clamp_f64": (*(_P,) * 5, _D, _L, _L, _P),
    # x, u_pred, v, a, u_out, v_out, a_out, delta (NULL but under the
    # "delta" policy), c_vpred, c_v, c_a, nodes, plane, stream
    "civi_newmark_update": (*(_P,) * 8, *(_F,) * 3, _L, _L, _P),
    "civi_newmark_update_f64": (*(_P,) * 8, *(_D,) * 3, _L, _L, _P),
}


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date library was reused
    log: str  # nvcc/ptxas output of the build ("" when reused)

    def call(self, entry: str, device, *args) -> None:
        """Launch C entry point ``entry`` with ``args`` and ``device``'s
        current stream (every entry's last argument) under ``device``'s
        guard and ``profiling.launch(entry)``; raise if it reports a CUDA
        error."""
        with torch.cuda.device(device), profiling.launch(entry):
            code = getattr(self.lib, entry)(
                *args, torch.cuda.current_stream(device).cuda_stream)
        if code != 0:
            text = self.lib.civi_error_string(code).decode()
            raise RuntimeError(f"{entry}: CUDA error {code} ({text}) at launch")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels are built from csrc/ at first use"
    )


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libcivi_kernels_{digest.hexdigest()[:16]}.so"
    build_seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        start = time.perf_counter()
        # one nvcc per source, all running at once, then one link
        jobs = []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
            cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC_DIR}", "-c", "-o", str(obj), str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs.append((cmd, obj, proc))
        logs, failed = [], []
        for cmd, obj, proc in jobs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"rc {proc.returncode}: {' '.join(cmd)}\n{out}")
        objects = [str(obj) for _, obj, _ in jobs]
        if not failed:
            cmd = [nvcc, "-shared", "-o", str(tmp), *objects]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"rc {proc.returncode}: {' '.join(cmd)}\n{logs[-1]}")
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
        build_seconds = time.perf_counter() - start
        log = "".join(logs)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.civi_error_string.argtypes = [ctypes.c_int]
    lib.civi_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib=lib, path=so, build_seconds=build_seconds, log=log)


def instance(name: str, dtype) -> str:
    """The C entry point of kernel ``name``'s instance for vectors of
    ``dtype``: ``name`` for torch.float32, ``name + "_f64"`` for
    torch.float64 (the kernels with a double instance); any other
    dtype raises TypeError."""
    if dtype == torch.float32:
        return name
    if dtype == torch.float64:
        return name + "_f64"
    raise TypeError(f"{name}: no kernel for dtype {dtype} (f32 or f64)")


def scalar(value, dtype) -> float:
    """A host scalar as the instance for ``dtype`` takes it: rounded to f32
    for f32 vectors, kept in f64 for f64 ones (the plain forms' rule)."""
    return float(np.float32(value)) if dtype == torch.float32 else float(value)


def count_launch(wrapper, dtype) -> None:
    """One launch of ``wrapper``'s kernel: ``.launches`` for its f32
    instance, ``.launches_f64`` for its f64 one."""
    if dtype == torch.float64:
        wrapper.launches_f64 += 1
    else:
        wrapper.launches += 1


def check_aligned(t, name: str, nbytes: int) -> None:
    """Raise unless ``t``'s data starts on an ``nbytes`` boundary (kernels
    that move rows as int4/float4 vectors)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: data not {nbytes}-byte aligned")


def check_homogeneous(model, name: str) -> None:
    """Raise on a heterogeneous grid: the constant-stencil kernels (K1/K5,
    K2) hold one material's taps; such a grid takes G3."""
    if not model.homogeneous:
        raise ValueError(
            f"{name}: a heterogeneous material grid has no constant "
            "stencil (its operator is G3, corner_gather)"
        )


def check_tensor(t, name: str, shape, dtype, device) -> None:
    """Validate a tensor handed to a kernel: device, dtype, shape and
    contiguity (the kernels index dense row-major buffers)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
