"""Isotropic elasticity helpers.

Pure-function rebuild of
the reference engine's include/cwf/physics/materials.hpp:116-155: Lame parameters,
6x6 Voigt stiffness, bulk/shear moduli, and Rayleigh (alpha, beta) from the
(xi, w1, w2) damping triple.  Voigt ordering is (xx, yy, zz, xy, yz, xz) with
engineering shear, matching the reference and the Slang kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from ..config.schema import Damping, Material


@dataclass(frozen=True)
class LamePair:
    lam: float  # first Lame parameter [Pa]
    mu: float  # shear modulus [Pa]


@dataclass(frozen=True)
class ElasticProperties:
    """Packaged elastic constants (materials.hpp:44-54)."""

    youngs_modulus: float
    poisson_ratio: float
    bulk_modulus: float
    shear_modulus: float
    lame: LamePair
    stiffness: np.ndarray  # (6, 6) float64, Voigt row-major


@dataclass(frozen=True)
class RayleighCoefficients:
    alpha: float  # mass-proportional term
    beta: float  # stiffness-proportional term


def compute_lame(youngs_modulus: float, poisson_ratio: float) -> LamePair:
    """(E, nu) -> (lambda, mu) (materials.hpp:116-122)."""
    denom = (1.0 + poisson_ratio) * (1.0 - 2.0 * poisson_ratio)
    lam = poisson_ratio * youngs_modulus / denom
    mu = youngs_modulus / (2.0 * (1.0 + poisson_ratio))
    return LamePair(lam, mu)


def make_stiffness_matrix(youngs_modulus: float, poisson_ratio: float) -> np.ndarray:
    """6x6 isotropic D matrix in Voigt form (materials.hpp:124-134)."""
    lame = compute_lame(youngs_modulus, poisson_ratio)
    c = lame.lam + 2.0 * lame.mu
    d = np.zeros((6, 6), dtype=np.float64)
    d[:3, :3] = lame.lam
    np.fill_diagonal(d[:3, :3], c)
    d[3, 3] = d[4, 4] = d[5, 5] = lame.mu
    return d


def make_properties(material: Material) -> ElasticProperties:
    """Config material -> packaged constants (materials.hpp:136-147)."""
    lame = compute_lame(material.youngs_modulus, material.poisson_ratio)
    bulk = lame.lam + (2.0 / 3.0) * lame.mu
    return ElasticProperties(
        youngs_modulus=material.youngs_modulus,
        poisson_ratio=material.poisson_ratio,
        bulk_modulus=bulk,
        shear_modulus=lame.mu,
        lame=lame,
        stiffness=make_stiffness_matrix(material.youngs_modulus, material.poisson_ratio),
    )


def compute_rayleigh(damping: Damping) -> RayleighCoefficients:
    """(xi, w1, w2) -> (alpha, beta) (materials.hpp:149-155)."""
    denom = damping.w1 + damping.w2
    alpha = 2.0 * damping.xi * damping.w1 * damping.w2 / denom
    beta = 2.0 * damping.xi / denom
    return RayleighCoefficients(alpha, beta)


def material_tables(
    properties: Sequence[ElasticProperties],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack per-material constants for device upload.

    Returns (lambda (M,), mu (M,), stiffness (M, 6, 6)).  The matrix-free
    TPU operator uses the (lambda, mu) tensor form — mathematically identical
    to the 6x6 Voigt product for isotropic materials — while the 6x6 table
    feeds derived-field stress evaluation (parity with pcg.cpp:632-640).
    """
    lam = np.array([p.lame.lam for p in properties], dtype=np.float64)
    mu = np.array([p.lame.mu for p in properties], dtype=np.float64)
    stiffness = np.stack([p.stiffness for p in properties]).astype(np.float64)
    return lam, mu, stiffness
