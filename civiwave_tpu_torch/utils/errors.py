"""Structured errors with breadcrumb context.

The reference engine never throws across public APIs: every layer returns
``std::expected<T, {message, context[]}>`` with a breadcrumb trail
(the reference engine's include/cwf/config/config.hpp:83-87 and analogous error
structs in mesh.hpp, pcg.hpp, ...).  In Python the idiomatic equivalent is a
single exception hierarchy carrying the same ``message`` + ``context`` payload
so callers (and tests) can assert on the breadcrumbs exactly like the
reference test-suite does.
"""

from __future__ import annotations

from typing import Sequence


class CwfError(Exception):
    """Base error carrying a message and a breadcrumb context trail."""

    def __init__(self, message: str, context: Sequence[str] = ()) -> None:
        self.message = message
        self.context = list(context)
        super().__init__(self.__str__())

    def __str__(self) -> str:  # pragma: no cover - repr convenience
        if self.context:
            return f"{self.message} [{' > '.join(self.context)}]"
        return self.message


class ConfigError(CwfError):
    """YAML scenario validation failure (cwf::config::ConfigError)."""


class MeshError(CwfError):
    """Gmsh parse failure (cwf::mesh::MeshError)."""


class PreprocessError(CwfError):
    """Mesh preprocessing failure (cwf::mesh::pre::PreprocessError)."""


class PackError(CwfError):
    """Buffer packing failure (cwf::mesh::pack::PackError)."""


class PcgError(CwfError):
    """Matrix-free solver failure (cwf::gpu::pcg::PcgError)."""


class StepError(CwfError):
    """Newmark stepper failure (cwf::gpu::newmark::StepError)."""


class ShardError(CwfError):
    """Partition planning failure (cwf::gpu::shard::ShardError)."""


class VtuError(CwfError):
    """VTU export failure (cwf::post::VtuError)."""


class ProbeError(CwfError):
    """Probe CSV logging failure (cwf::post::ProbeError)."""
