"""One implicit Newmark frame of the scenario, and the numbers that judge
another program's frame against it.

Newmark-beta with beta = 1/4, gamma = 1/2, Rayleigh damping C = alpha M +
beta_R K, lumped mass, the x = 0 plane fixed.  For frame k at time t_k:

    K_eff u_k = f(t_k) + M (a0 u + a2 v + a3 a) + C (a1 u + a4 v + a5 a)
    K_eff     = (1 + a1 beta_R) K + (a0 + a1 alpha) M

with (u, v, a) the state after frame k - 1, then

    a_k = (u_k - u_pred) / (beta dt^2),  v_k = v_pred + gamma/(beta dt) (u_k - u_pred)

where u_pred = u + dt v + (1/2 - beta) dt^2 a and v_pred = v + (1 -
gamma) dt a.  Fixed rows hold u = 0: their equation is the identity.
Everything here is float64 unless a dtype is passed.  The materials are
one (lam, mu and rho as floats) or a configuration's own layout (per-cell
float64 tensors, ``benchmarks/reference/materials``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import elastic, materials
from .mesh import Box, parse_box

BETA, GAMMA = 0.25, 0.5


@dataclass
class System:
    box: Box
    lam: float | torch.Tensor  # a float, or (cells,) float64 per cell
    mu: float | torch.Tensor
    rho: float | torch.Tensor
    alpha: float  # Rayleigh mass factor
    beta_r: float  # Rayleigh stiffness factor
    dt: float
    traction: tuple  # (3,) Pa, scaled by the curve
    curve_t: np.ndarray
    curve_v: np.ndarray
    mass: torch.Tensor  # (N,)
    fixed: torch.Tensor  # (N, 3) bool
    face: torch.Tensor  # (N,) traction area per node

    @property
    def device(self):
        return self.mass.device

    def coefficients(self):
        dt = self.dt
        return dict(
            a0=1.0 / (BETA * dt * dt), a1=GAMMA / (BETA * dt), a2=1.0 / (BETA * dt),
            a3=1.0 / (2.0 * BETA) - 1.0, a4=GAMMA / BETA - 1.0,
            a5=dt * (GAMMA / (2.0 * BETA) - 1.0))

    def load(self, t: float, dtype=torch.float64) -> torch.Tensor:
        scale = float(np.interp(t, self.curve_t, self.curve_v))
        value = torch.tensor(self.traction, dtype=dtype, device=self.device)
        return (scale * self.face.to(dtype))[:, None] * value

    def stiffness(self, x: torch.Tensor) -> torch.Tensor:
        """K x with the fixed entries of x taken as zero."""
        return elastic.stiffness_apply(self.box, self.lam, self.mu,
                                       x.masked_fill(self.fixed, 0.0))

    def scalars(self):
        c = self.coefficients()
        return 1.0 + c["a1"] * self.beta_r, c["a0"] + c["a1"] * self.alpha

    def keff(self, x: torch.Tensor) -> torch.Tensor:
        ss, mf = self.scalars()
        out = ss * self.stiffness(x) + mf * self.mass.to(x.dtype)[:, None] * x
        return torch.where(self.fixed, x, out)

    def rhs(self, prev, t: float, dtype=torch.float64) -> torch.Tensor:
        u, v, a = (p.to(dtype) for p in prev)
        c = self.coefficients()
        m = self.mass.to(dtype)[:, None]
        damp = c["a1"] * u + c["a4"] * v + c["a5"] * a
        b = (self.load(t, dtype) + m * (c["a0"] * u + c["a2"] * v + c["a3"] * a)
             + self.alpha * m * damp + self.beta_r * self.stiffness(damp))
        return torch.where(self.fixed, torch.zeros_like(b), b)

    def predict(self, prev):
        """(u_pred, v_pred) from the state before the frame."""
        u, v, a = prev
        dt = self.dt
        return u + dt * v + (0.5 - BETA) * dt * dt * a, v + (1.0 - GAMMA) * dt * a

    def update(self, prev, u_new: torch.Tensor):
        """(v_k, a_k) from the state before the frame and its u_k."""
        u_pred, v_pred = self.predict(tuple(p.to(u_new.dtype) for p in prev))
        delta = u_new - u_pred
        dt = self.dt
        return v_pred + GAMMA / (BETA * dt) * delta, delta / (BETA * dt * dt)


def material_fields(box: Box, scenario: dict, device, config: str | None = None):
    """(lam, mu, rho): the layout of ``materials/<config>.py`` where the
    configuration has one, as (cells,) float64 tensors; otherwise the
    scenario's one material, as floats."""
    cell_fields = materials.layout(config)
    if cell_fields is not None:
        fields = tuple(cell_fields(box, scenario, device))
        for f in fields:
            if f.dtype != torch.float64 or tuple(f.shape) != (box.cell_count,):
                raise ValueError(
                    f"{materials.path(config)} gave a {f.dtype} field of shape "
                    f"{tuple(f.shape)}; the reference takes float64 "
                    f"({box.cell_count},)")
        return fields
    mats = scenario["materials"]
    if len(mats) != 1:
        needs = materials.path(config or "<config>")
        raise ValueError(
            f"the scenario has {len(mats)} materials and no layout says which "
            f"cells each takes: the reference needs {needs}")
    (mat,) = mats
    lam, mu = elastic.lame(float(mat["E"]), float(mat["nu"]))
    return lam, mu, float(mat["rho"])


def build_system(scenario: dict, dt: float, curve, device,
                 config: str | None = None) -> System:
    """The reference's own system for a scenario node (its materials, as
    ``material_fields`` finds them for the configuration ``config``; one
    traction group on the x = nx face; the x = 0 plane fixed) and the load
    curve as (t, value) points."""
    box = parse_box(scenario["mesh"]["path"])
    lam, mu, rho = material_fields(box, scenario, device, config)
    damping = scenario["damping"]
    xi, w1, w2 = float(damping["xi"]), float(damping["w1"]), float(damping["w2"])
    (traction,) = scenario["loads"]["tractions"]
    points = np.asarray(curve, dtype=np.float64)
    return System(
        box=box, lam=lam, mu=mu, rho=rho,
        alpha=2.0 * xi * w1 * w2 / (w1 + w2), beta_r=2.0 * xi / (w1 + w2),
        dt=float(dt), traction=tuple(float(t) for t in traction["value"]),
        curve_t=points[:, 0], curve_v=points[:, 1],
        mass=elastic.lumped_mass(box, rho, device),
        fixed=box.fixed_mask(device), face=box.face_weights(device))


def judge(system: System, prev, new, t: float) -> dict:
    """The numbers that judge a frame: ``prev`` and ``new`` are (u, v, a)
    nodal rows before and after it, as the program gave them.

    * ``residual``: ||b - K_eff u_k|| / ||b||, the measure of the solver's
      relative tolerance, in float64 on the reference's own system;
    * ``residual_max``: the same in the largest entry, which one wrong node
      cannot hide in;
    * ``u_update`` / ``v_update``: how far u_k and v_k lie from the Newmark
      update with the frame's a_k, u_pred + beta dt^2 a_k and v_pred +
      gamma dt a_k, over the largest entry of u_k / v_k.  Measured in u
      and v, a_k is judged at the precision the state carries it: where
      the solve takes no iteration a_k is 0 and u_k = u_pred, and a taken
      back from u_k - u_pred would be rounding alone.
    """
    prev = tuple(p.to(system.device, torch.float64) for p in prev)
    u, v, a = (p.to(system.device, torch.float64) for p in new)
    b = system.rhs(prev, t)
    r = b - system.keff(u)
    u_pred, v_pred = system.predict(prev)
    dt = system.dt
    return dict(
        residual=ratio(r.norm(), b.norm()),
        residual_max=ratio(r.abs().max(), b.abs().max()),
        u_update=ratio((u - u_pred - BETA * dt * dt * a).abs().max(), u.abs().max()),
        v_update=ratio((v - v_pred - GAMMA * dt * a).abs().max(), v.abs().max()),
    )


def ratio(num, den) -> float:
    """num / den, where a frame that should be all zeros (den 0, as the
    first frame of a load that starts at 0) reads 0 if it is and inf if
    not."""
    num, den = float(num), float(den)
    if den > 0.0:
        return num / den
    return 0.0 if num == 0.0 else float("inf")
