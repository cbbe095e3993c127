"""A configuration and a generated load history -> the scenario the program
receives (a scenario node, parsed by the program's own config loader).

The configuration file holds the scenario node without its time step,
curves and output; the traffic adds them: ``time.dt`` fixed (no adaptive
step), the curve ``load`` that scales the configuration's one traction,
and the output's probes and VTU stride where the mix records output.
"""

from __future__ import annotations

import copy

from benchmarks.reference.mesh import parse_box

from .traffic import Traffic


def probe_nodes(mesh_path: str, fractions) -> list:
    """Node ids of probes given as fractions (fx, fy, fz) of the box."""
    box = parse_box(mesh_path)
    return [box.node_id(round(fx * box.nx), round(fy * box.ny), round(fz * box.nz))
            for fx, fy, fz in fractions]


def scenario_node(config: dict, traffic: Traffic, mesh_path: str | None = None) -> dict:
    """The scenario node of ``config`` under ``traffic``; ``mesh_path``
    replaces the configuration's mesh (the tests' small sizes)."""
    node = copy.deepcopy(config["scenario"])
    if mesh_path is not None:
        node["mesh"] = {"path": mesh_path}
    node["time"] = {"dt": traffic.dt, "adaptive": False}
    node["curves"] = {"load": [list(p) for p in traffic.curve]}
    for t in node["loads"]["tractions"]:
        t["scale_curve"] = "load"
    if traffic.output is not None:
        node["output"] = {
            "vtu_stride": int(traffic.output["vtu_stride"]),
            "probes": probe_nodes(node["mesh"]["path"], traffic.output["probes"]),
        }
    else:
        node["output"] = {"vtu_stride": 1, "probes": []}
    return node
