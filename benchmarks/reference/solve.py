"""The reference's own Newmark frame: K_eff u_k = b by conjugate gradients
with a Jacobi preconditioner, vectors in a chosen dtype, reductions in
float32 or wider, then the Newmark update in the same dtype.

In bfloat16 this is the control: the step a later change might be
tempted to take below the configuration's float32, which the comparison
has to fail.
"""

from __future__ import annotations

import torch

from . import elastic
from .newmark import BETA, System


def frame(system: System, prev, t: float, dtype, tolerance: float,
          max_iterations: int):
    """(u_k, v_k, a_k) from ``prev`` = (u, v, a), stopping when ||r|| <=
    tolerance * ||b|| or after ``max_iterations``; returns the state and
    the iterations taken."""
    red = torch.float64 if dtype == torch.float64 else torch.float32
    prev = tuple(p.to(system.device, dtype) for p in prev)
    ss, mf = system.scalars()
    diag = (ss * elastic.stiffness_diagonal(system.box, system.lam, system.mu,
                                            system.device, torch.float64)
            + mf * system.mass[:, None])
    inv = torch.where(system.fixed, 1.0, 1.0 / diag).to(dtype)
    b = system.rhs(prev, t, dtype=red).to(dtype)

    def keff(x):
        return system.keff(x.to(dtype)).to(dtype)

    def dot(p, q):
        return torch.sum(p.to(red) * q.to(red))

    u, v, a = prev
    dt = system.dt
    x = (u + dt * v + (0.5 - BETA) * dt * dt * a).to(dtype)  # the predictor
    x = torch.where(system.fixed, torch.zeros_like(x), x)
    r = b - keff(x)
    z = inv * r
    p = z
    rz = dot(r, z)
    b_norm = float(dot(b, b).sqrt())
    iterations = 0
    while iterations < max_iterations and float(dot(r, r).sqrt()) > tolerance * b_norm:
        q = keff(p)
        step = rz / dot(p, q)
        x = x + step.to(dtype) * p
        r = r - step.to(dtype) * q
        z = inv * r
        rz_new = dot(r, z)
        p = z + (rz_new / rz).to(dtype) * p
        rz = rz_new
        iterations += 1
    v_new, a_new = system.update(prev, x)
    return (x, v_new.to(dtype), a_new.to(dtype)), iterations
