"""Wrapper of the Chronopoulos-Gear direction update, with its plain
version.

``cg_direction_update`` (``csrc/pcg_vector_update.cu``) is the vector work
of one iteration of the fused PCG loop (``solver/pcg.solve_pcg_fused``),
which calls it at the top of each iteration with the alpha and beta the
host kept from the iteration before:

    p = bc ? 0 : u + beta p        s = bc ? 0 : w + beta s
    x = x + alpha p                r = r - alpha s

and, on a solve's first call (``beta`` None), p = bc ? 0 : u and s = bc ?
0 : w.  It replaces no Pallas kernel: the reference leaves these axpys to
XLA.  alpha and beta are 0-d tensors of the reduction dtype (f64, or f32),
read by the kernel on the device and rounded to the vector dtype there.

A CPU tensor takes the plain version, the torch composition, which returns
new tensors.  A CUDA tensor launches the kernel (its f64 instance for f64
vectors) or raises: the kernel writes x, r, p and s in place (p and s
allocated on the first call) and returns them, so the caller must own the
x and r it passes.  It reads the vectors as 16-byte and the mask as 4-byte
words, so it refuses buffers that do not start on such a boundary (a view
at an offset; torch's own allocations start on 256 bytes).  Both forms
give the same bits.
``cg_direction_update.launches`` counts the f32 launches,
``.launches_f64`` the f64 ones.
"""

from __future__ import annotations

import torch

from . import _build


def cg_direction_update_plain(bc, x, r, p, s, u, w, alpha, beta, dtype):
    """Plain PyTorch direction update: returns new ``(x, r, p, s)``."""
    if beta is None:
        p = u.masked_fill(bc, 0.0).to(dtype)
        s = w.masked_fill(bc, 0.0).to(dtype)
    else:
        beta_v = beta.to(dtype)
        p = (u + beta_v * p).masked_fill(bc, 0.0)
        s = (w + beta_v * s).to(dtype).masked_fill(bc, 0.0)
    alpha_v = alpha.to(dtype)
    return x + alpha_v * p, r - alpha_v * s, p, s


def _check_scalar(t, name: str, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {t.dtype}, expected float32 or float64")
    if t.numel() != 1:
        raise ValueError(f"{name}: {t.numel()} values, expected one")


def cg_direction_update(bc, x, r, p, s, u, w, alpha, beta, dtype):
    """The direction update of ``dtype`` vectors; kernel on CUDA, plain
    version on CPU.  Returns ``(x, r, p, s)``."""
    if x.device.type == "cpu":
        return cg_direction_update_plain(bc, x, r, p, s, u, w, alpha, beta, dtype)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    entry = _build.instance("civi_cg_direction_update", dtype)
    shape = x.shape
    for name, v in (("x", x), ("r", r), ("u", u), ("w", w)):
        _build.check_tensor(v, name, shape, dtype, dev)
    _build.check_tensor(bc, "bc_mask", shape, torch.bool, dev)
    _check_scalar(alpha, "alpha", dev)
    if beta is None:
        p, s = torch.empty_like(u), torch.empty_like(w)
    else:
        _check_scalar(beta, "beta", dev)
        if beta.dtype != alpha.dtype:
            raise TypeError(f"beta: dtype {beta.dtype}, alpha's {alpha.dtype}")
        _build.check_tensor(p, "p", shape, dtype, dev)
        _build.check_tensor(s, "s", shape, dtype, dev)
    for name, v in (("x", x), ("r", r), ("p", p), ("s", s), ("u", u), ("w", w)):
        _build.check_aligned(v, name, 16)
    _build.check_aligned(bc, "bc_mask", 4)
    library = _build.load_library()
    library.call(
        entry, dev, x.data_ptr(), r.data_ptr(), p.data_ptr(), s.data_ptr(),
        u.data_ptr(), w.data_ptr(), bc.data_ptr(), alpha.data_ptr(),
        None if beta is None else beta.data_ptr(),
        int(alpha.dtype == torch.float64), x.numel(),
    )
    _build.count_launch(cg_direction_update, dtype)
    return x, r, p, s


cg_direction_update.launches = 0
cg_direction_update.launches_f64 = 0
