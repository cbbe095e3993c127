"""Wrappers of the Newmark stepper's three vector passes, with their plain
versions.

``solver/stepper.newmark_step`` runs a frame's vector arithmetic as three
passes (``csrc/newmark_vectors.cu``):

    newmark_rhs          u_pred = (u + dt v) + c_pred a
                         d = (a1 u + a4 v) + a5 a
                         rhs = (f + m ((a0 u + a2 v) + a3 a)) + (alpha_r m) d
    newmark_rhs_clamp    rhs = bc ? bc_value : (rhs + beta_r Kd) + Cd
    newmark_update       delta = x - u_pred,  u = u_pred + delta,
                         v = (v + c_vpred a) + c_v delta,  a = c_a delta

with the stiffness-only operator on d (and the absorbing term C d) between
the first two, and the PCG between the last two.  They replace no Pallas
kernel: the reference leaves these terms to XLA.  The scalars are the
host's f64 values (:class:`NewmarkScalars`), each rounded once to the
vector dtype; alpha_r m is rounded to f32 (the f32 mass times a scalar).

The vectors are the structured grid's (3, X, Y, Z) with a (1, X, Y, Z)
mass, or the general path's (N, 3) rows with an (N, 1) mass
(``model.mass_b``); any other mass shape raises.  So do vectors of mixed
shapes, dtypes or devices, a mass or bc_value that is not f32, a mask
that is not bool, and a tensor that is not contiguous.  The kernels take
one node a thread with single-value accesses, so a view at any offset is
taken.  The checks are the same on both devices.

A CPU tensor takes the plain version, the torch composition, which returns
new tensors.  A CUDA tensor launches the kernel (its f64 instance for f64
vectors) or raises; ``newmark_rhs_clamp`` writes rhs in place there.  Both
forms give the same bits.  ``<wrapper>.launches`` counts the f32 launches,
``.launches_f64`` the f64 ones.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _build


class NewmarkScalars(NamedTuple):
    """The passes' scalars, host f64 values (newmark.cpp:34-47)."""

    dt: float
    c_pred: float  # (0.5 - beta) dt^2
    a0: float
    a2: float
    a3: float
    a1: float
    a4: float
    a5: float
    alpha_r: float  # Rayleigh mass coefficient
    beta_r: float  # Rayleigh stiffness coefficient
    c_vpred: float  # (1 - gamma) dt
    c_v: float  # gamma / (beta dt)
    c_a: float  # 1 / (beta dt^2)


_s = _build.scalar  # a host f64 value as the vector dtype's scalar


def newmark_rhs_plain(mass, u, v, a, f, k: NewmarkScalars):
    """Plain PyTorch predictor and partial right-hand side: returns new
    ``(u_pred, d, rhs)``."""
    dt = u.dtype
    u_pred = u + _s(k.dt, dt) * v + _s(k.c_pred, dt) * a
    mass_term = mass * (_s(k.a0, dt) * u + _s(k.a2, dt) * v + _s(k.a3, dt) * a)
    d = _s(k.a1, dt) * u + _s(k.a4, dt) * v + _s(k.a5, dt) * a
    rhs = f + mass_term + _s(k.alpha_r, dt) * mass * d
    return u_pred, d, rhs


def newmark_rhs_clamp_plain(rhs, kd, absorb, bc, bc_value, k: NewmarkScalars):
    """Plain PyTorch Rayleigh-beta and absorbing terms (either None where
    absent) and Dirichlet clamp: returns a new rhs."""
    if kd is not None:
        rhs = rhs + _s(k.beta_r, rhs.dtype) * kd
    if absorb is not None:
        rhs = rhs + absorb
    return torch.where(bc, bc_value.to(rhs.dtype), rhs)


def newmark_update_plain(x, u_pred, v, a, k: NewmarkScalars, write_delta: bool):
    """Plain PyTorch Newmark update from the solution ``x``: returns new
    ``(u, v, a, delta)``, delta None unless ``write_delta``."""
    dt = x.dtype
    v_pred = v + _s(k.c_vpred, dt) * a
    delta = x - u_pred
    return (u_pred + delta, v_pred + _s(k.c_v, dt) * delta, _s(k.c_a, dt) * delta,
            delta if write_delta else None)


def _plane(shape, mass) -> int:
    """Nodes per component plane of the grid layout (3, X, Y, Z), 0 for
    node rows (N, 3); raises on other vectors and on a mass (where given)
    that is not the layout's (1, X, Y, Z) or (N, 1)."""
    shape = tuple(shape)
    if len(shape) == 4 and shape[0] == 3:
        plane, mass_shape = math.prod(shape[1:]), (1, *shape[1:])
    elif len(shape) == 2 and shape[1] == 3:
        plane, mass_shape = 0, (shape[0], 1)
    else:
        raise ValueError(f"vectors: shape {shape} is neither (3, X, Y, Z) nor (N, 3)")
    if mass is not None and tuple(mass.shape) != mass_shape:
        raise ValueError(f"mass: shape {tuple(mass.shape)}, expected {mass_shape} "
                         f"for vectors of shape {shape}")
    return plane


def _check(vectors, mass=None, bc=None, bc_value=None):
    """Check a pass's ``vectors`` ((name, tensor) pairs, None skipped: the
    first sets shape, dtype and device), mass, mask and bc_value; returns
    (nodes, plane)."""
    name0, v0 = vectors[0]
    shape, dtype, device = v0.shape, v0.dtype, v0.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name0}: dtype {dtype}, expected float32 or float64")
    plane = _plane(shape, mass)
    checks = [(n, t, shape, dtype) for n, t in vectors]
    checks += [("mass", mass, None if mass is None else mass.shape, torch.float32),
               ("bc_mask", bc, shape, torch.bool),
               ("bc_value", bc_value, shape, torch.float32)]
    for name, t, want_shape, want_dtype in checks:
        if t is not None:
            _build.check_tensor(t, name, want_shape, want_dtype, device)
    return v0.numel() // 3, plane


def _device(t) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {t.device}")
    return t.device.type


def _ptr(t):
    return None if t is None else t.data_ptr()


def newmark_rhs(mass, u, v, a, f, k: NewmarkScalars):
    """Pass A: ``(u_pred, d, rhs)`` of the pre-step state; kernel on CUDA,
    plain version on CPU."""
    nodes, plane = _check([("u", u), ("v", v), ("a", a), ("f", f)], mass=mass)
    if _device(u) == "cpu":
        return newmark_rhs_plain(mass, u, v, a, f, k)
    dtype = u.dtype
    u_pred, d, rhs = (torch.empty_like(u) for _ in range(3))
    scalars = [_s(x, dtype) for x in (k.dt, k.c_pred, k.a0, k.a2, k.a3, k.a1,
                                      k.a4, k.a5)]
    _build.load_library().call(
        _build.instance("civi_newmark_rhs", dtype), u.device,
        u.data_ptr(), v.data_ptr(), a.data_ptr(), f.data_ptr(), mass.data_ptr(),
        u_pred.data_ptr(), d.data_ptr(), rhs.data_ptr(), *scalars,
        _s(k.alpha_r, torch.float32), nodes, plane,
    )
    _build.count_launch(newmark_rhs, dtype)
    return u_pred, d, rhs


def newmark_rhs_clamp(rhs, kd, absorb, bc, bc_value, k: NewmarkScalars):
    """Pass B: ``rhs`` with ``beta_r kd`` and ``absorb`` added (each None
    where the model has no such term) and the Dirichlet clamp; in place on
    CUDA, a new tensor on CPU."""
    nodes, plane = _check([("rhs", rhs), ("kd", kd), ("absorb", absorb)],
                          bc=bc, bc_value=bc_value)
    if _device(rhs) == "cpu":
        return newmark_rhs_clamp_plain(rhs, kd, absorb, bc, bc_value, k)
    dtype = rhs.dtype
    _build.load_library().call(
        _build.instance("civi_newmark_rhs_clamp", dtype), rhs.device,
        rhs.data_ptr(), _ptr(kd), _ptr(absorb), bc.data_ptr(),
        bc_value.data_ptr(), _s(k.beta_r, dtype), nodes, plane,
    )
    _build.count_launch(newmark_rhs_clamp, dtype)
    return rhs


def newmark_update(x, u_pred, v, a, k: NewmarkScalars, write_delta: bool = False):
    """Pass C: the new ``(u, v, a, delta)`` from the solution ``x`` (delta
    None unless ``write_delta``); kernel on CUDA, plain version on CPU."""
    nodes, plane = _check([("x", x), ("u_pred", u_pred), ("v", v), ("a", a)])
    if _device(x) == "cpu":
        return newmark_update_plain(x, u_pred, v, a, k, write_delta)
    dtype = x.dtype
    u_new, v_new, a_new = (torch.empty_like(x) for _ in range(3))
    delta = torch.empty_like(x) if write_delta else None
    _build.load_library().call(
        _build.instance("civi_newmark_update", dtype), x.device,
        x.data_ptr(), u_pred.data_ptr(), v.data_ptr(), a.data_ptr(),
        u_new.data_ptr(), v_new.data_ptr(), a_new.data_ptr(), _ptr(delta),
        *(_s(c, dtype) for c in (k.c_vpred, k.c_v, k.c_a)), nodes, plane,
    )
    _build.count_launch(newmark_update, dtype)
    return u_new, v_new, a_new, delta


for _wrapper in (newmark_rhs, newmark_rhs_clamp, newmark_update):
    _wrapper.launches = 0
    _wrapper.launches_f64 = 0
