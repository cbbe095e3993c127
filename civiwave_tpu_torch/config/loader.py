"""YAML scenario loader with aggressive validation.

Reproduces the validation matrix of the reference loader
(the reference engine's src/config/config.cpp:148-605) including error messages and
breadcrumb trails, so a scenario that the reference rejects is rejected here
with the same diagnostics:

* materials: non-empty, E > 0, nu in (-0.999, 0.5), rho > 0, unique names
  (config.cpp:171-217)
* assignments: non-empty, reference known materials (config.cpp:220-249)
* damping: xi in (0,1), w1 > 0, w2 > w1 (config.cpp:252-278)
* time: dt > 0, min_dt >= 0, max_dt >= dt, defaults min=0/max=dt
  (config.cpp:281-309)
* solver: max_iters >= 1, tolerances > 0 (config.cpp:312-336)
* precision: vectors/reductions strings required (config.cpp:339-352)
* curves: non-empty sequences of [t, v] with non-decreasing times
  (config.cpp:355-398)
* loads: gravity vec3 required; tractions/points validated with curve
  references (config.cpp:401-498)
* dirichlet.fixes: dof subset of {x,y,z}, non-empty, optional per-axis value
  overrides (config.cpp:501-567)
* output: vtu_stride >= 1, probes list of ints (config.cpp:570-602)

Two extensions of the reference's schema, both optional:
``boundaries.absorbing`` (surface groups with viscous dashpots) and
``box_regions`` (named boxes of cells of a ``synthetic://box`` mesh, by
fractions of its extent: a list of ``{group, lo: [fx, fy, fz], hi: [fx,
fy, fz]}`` with 0 <= lo < hi <= 1, unique names none of which is one of
the box's own groups).
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence, Tuple

from ..utils.errors import ConfigError
from .schema import (
    Assignment,
    BoxRegion,
    Config,
    Curve,
    Damping,
    DirichletFix,
    Loads,
    Material,
    OutputSettings,
    PointLoad,
    PrecisionSettings,
    SolverSettings,
    SurfaceTraction,
    TimeSettings,
)


BOX_PREFIX = "synthetic://box/"
# the physical groups of the synthetic box mesh itself (utils/synthetic.py)
BOX_GROUPS = (
    "FIXED", "LOAD_FACE", "SOLID",
    "SIDE_X0", "SIDE_X1", "SIDE_Y0", "SIDE_Y1", "SIDE_Z0", "SIDE_Z1",
)


def _err(message: str, ctx: Sequence[str]) -> ConfigError:
    return ConfigError(message, ctx)


def _as_float(node: Any, ctx: Sequence[str]) -> float:
    if isinstance(node, bool) or not isinstance(node, (int, float, str)):
        raise _err("expected a numeric scalar", ctx)
    try:
        return float(node)
    except (TypeError, ValueError):
        raise _err("expected a numeric scalar", ctx) from None


def _as_uint(node: Any, ctx: Sequence[str]) -> int:
    if isinstance(node, bool) or not isinstance(node, int):
        try:
            value = int(str(node))
        except (TypeError, ValueError):
            raise _err("expected a non-negative integer", ctx) from None
    else:
        value = node
    if value < 0:
        raise _err("expected a non-negative integer", ctx)
    return value


def _as_str(node: Any, ctx: Sequence[str]) -> str:
    if not isinstance(node, str):
        raise _err("expected a string scalar", ctx)
    return node


def _as_bool(node: Any, ctx: Sequence[str]) -> bool:
    if not isinstance(node, bool):
        raise _err("expected a boolean scalar", ctx)
    return node


def _node_to_vec3(node: Any, ctx: Sequence[str]) -> Tuple[float, float, float]:
    # config.cpp:34-56
    if not isinstance(node, (list, tuple)) or len(node) != 3:
        raise _err("expected sequence[3] for vector", ctx)
    values = []
    for i, item in enumerate(node):
        values.append(_as_float(item, [*ctx, f"[{i}]"]))
    return (values[0], values[1], values[2])


def _node_to_optional_vec3(
    node: Any, ctx: Sequence[str]
) -> Tuple[Optional[float], Optional[float], Optional[float]]:
    # config.cpp:58-89
    if node is None:
        return (None, None, None)
    if not isinstance(node, (list, tuple)) or len(node) != 3:
        raise _err("expected sequence[3] for value override", ctx)
    out: List[Optional[float]] = []
    for i, item in enumerate(node):
        if item is None:
            out.append(None)
        else:
            out.append(_as_float(item, [*ctx, f"[{i}]"]))
    return (out[0], out[1], out[2])


def load_config_from_file(path: str) -> Config:
    """Parse and validate a YAML scenario file (config.cpp:118-133)."""
    # imported here, not at module level: parse_config_node must work on
    # hosts without pyyaml (scenarios built as dicts in code)
    import yaml

    if not os.path.isfile(path):
        raise _err(f"unable to open config file: {path}", [str(path)])
    try:
        with open(path, "r", encoding="utf-8") as handle:
            root = yaml.safe_load(handle)
    except yaml.YAMLError as exc:
        raise _err(f"YAML parse error: {exc}", [str(path)]) from None
    return parse_config_node(root)


def load_config_from_string(yaml_text: str) -> Config:
    """Parse and validate a YAML scenario string (config.cpp:135-146)."""
    import yaml

    try:
        root = yaml.safe_load(yaml_text)
    except yaml.YAMLError as exc:
        raise _err(f"YAML parse error: {exc}", []) from None
    return parse_config_node(root)


def parse_config_node(root: Any) -> Config:
    """Validate an already-parsed YAML document (config.cpp:148-605)."""
    if not isinstance(root, dict):
        raise _err("config root must be a mapping", [])

    # mesh -----------------------------------------------------------------
    mesh_node = root.get("mesh")
    if not isinstance(mesh_node, dict):
        raise _err("missing 'mesh' section", ["mesh"])
    mesh_path = mesh_node.get("path")
    if not isinstance(mesh_path, str):
        raise _err("mesh.path must be a scalar string", ["mesh", "path"])

    # materials ------------------------------------------------------------
    materials_node = root.get("materials")
    if not isinstance(materials_node, list) or len(materials_node) == 0:
        raise _err("materials must be a non-empty sequence", ["materials"])
    materials: List[Material] = []
    material_names = set()
    for i, node in enumerate(materials_node):
        ctx = ["materials", f"[{i}]"]
        if not isinstance(node, dict):
            raise _err("material entry must be a map", ctx)
        for key in ("name", "E", "nu", "rho"):
            if key not in node:
                raise _err(f"material missing required key '{key}'", ctx)
        name = _as_str(node["name"], [*ctx, "name"])
        e_mod = _as_float(node["E"], [*ctx, "E"])
        nu = _as_float(node["nu"], [*ctx, "nu"])
        rho = _as_float(node["rho"], [*ctx, "rho"])
        if e_mod <= 0.0:
            raise _err("material.E must be > 0", [*ctx, "E"])
        if nu <= -0.999 or nu >= 0.5:
            raise _err("material.nu must be (-0.999, 0.5)", [*ctx, "nu"])
        if rho <= 0.0:
            raise _err("material.rho must be > 0", [*ctx, "rho"])
        if name in material_names:
            raise _err("material names must be unique", [*ctx, "name"])
        material_names.add(name)
        materials.append(Material(name, e_mod, nu, rho))

    # assignments ----------------------------------------------------------
    assignments_node = root.get("assignments")
    if not isinstance(assignments_node, list) or len(assignments_node) == 0:
        raise _err("assignments must be a non-empty sequence", ["assignments"])
    assignments: List[Assignment] = []
    for i, node in enumerate(assignments_node):
        ctx = ["assignments", f"[{i}]"]
        if not isinstance(node, dict):
            raise _err("assignment must be a map", ctx)
        if "group" not in node or "material" not in node:
            raise _err("assignment requires 'group' and 'material'", ctx)
        group = _as_str(node["group"], [*ctx, "group"])
        material = _as_str(node["material"], [*ctx, "material"])
        if material not in material_names:
            raise _err("assignment references unknown material", [*ctx, "material"])
        assignments.append(Assignment(group, material))

    # damping ----------------------------------------------------------------
    damping_node = root.get("damping")
    if not isinstance(damping_node, dict):
        raise _err("missing damping map", ["damping"])
    for key in ("xi", "w1", "w2"):
        if key not in damping_node:
            raise _err(f"damping missing required key '{key}'", ["damping"])
    xi = _as_float(damping_node["xi"], ["damping", "xi"])
    w1 = _as_float(damping_node["w1"], ["damping", "w1"])
    w2 = _as_float(damping_node["w2"], ["damping", "w2"])
    if xi <= 0.0 or xi >= 1.0:
        raise _err("damping.xi must be (0,1)", ["damping", "xi"])
    if w1 <= 0.0:
        raise _err("damping.w1 must be > 0", ["damping", "w1"])
    if w2 <= w1:
        raise _err("damping.w2 must be > damping.w1", ["damping", "w2"])
    damping = Damping(xi, w1, w2)

    # time -------------------------------------------------------------------
    time_node = root.get("time")
    if not isinstance(time_node, dict):
        raise _err("missing time map", ["time"])
    if "dt" not in time_node or "adaptive" not in time_node:
        raise _err("time requires 'dt' and 'adaptive'", ["time"])
    initial_dt = _as_float(time_node["dt"], ["time", "dt"])
    adaptive = _as_bool(time_node["adaptive"], ["time", "adaptive"])
    min_dt = (
        _as_float(time_node["min_dt"], ["time", "min_dt"]) if "min_dt" in time_node else 0.0
    )
    max_dt = (
        _as_float(time_node["max_dt"], ["time", "max_dt"])
        if "max_dt" in time_node
        else initial_dt
    )
    if initial_dt <= 0.0:
        raise _err("time.dt must be > 0", ["time", "dt"])
    if min_dt < 0.0:
        raise _err("time.min_dt must be >= 0", ["time", "min_dt"])
    if max_dt < initial_dt:
        raise _err("time.max_dt must be >= time.dt", ["time", "max_dt"])
    time_settings = TimeSettings(initial_dt, adaptive, min_dt, max_dt)

    # solver -----------------------------------------------------------------
    solver_node = root.get("solver")
    if not isinstance(solver_node, dict):
        raise _err("missing solver map", ["solver"])
    for key in ("type", "preconditioner", "tol_runtime", "tol_pause", "max_iters"):
        if key not in solver_node:
            raise _err(f"solver missing required key '{key}'", ["solver"])
    solver = SolverSettings(
        type=_as_str(solver_node["type"], ["solver", "type"]),
        preconditioner=_as_str(solver_node["preconditioner"], ["solver", "preconditioner"]),
        runtime_tolerance=_as_float(solver_node["tol_runtime"], ["solver", "tol_runtime"]),
        pause_tolerance=_as_float(solver_node["tol_pause"], ["solver", "tol_pause"]),
        max_iterations=_as_uint(solver_node["max_iters"], ["solver", "max_iters"]),
        warm_start_policy=_as_str(
            solver_node.get("warm_start_policy", "predictor"),
            ["solver", "warm_start_policy"],
        ),
        variant=_as_str(
            solver_node.get("variant", "auto"), ["solver", "variant"]
        ),
        replace_every=_as_uint(
            solver_node.get("replace_every", 10),
            ["solver", "replace_every"],
        ),
    )
    if solver.max_iterations == 0:
        raise _err("solver.max_iters must be >= 1", ["solver", "max_iters"])
    if solver.runtime_tolerance <= 0.0 or solver.pause_tolerance <= 0.0:
        raise _err("solver tolerances must be > 0", ["solver"])
    if solver.warm_start_policy not in ("predictor", "solution", "delta"):
        raise _err(
            "solver.warm_start_policy must be 'predictor', 'solution' or "
            "'delta'",
            ["solver", "warm_start_policy", solver.warm_start_policy],
        )
    if solver.variant not in ("auto", "classic", "fused", "pipelined"):
        raise _err(
            "solver.variant must be 'auto', 'classic', 'fused' or "
            "'pipelined'",
            ["solver", "variant", solver.variant],
        )

    # precision ----------------------------------------------------------------
    precision_node = root.get("precision")
    if not isinstance(precision_node, dict):
        raise _err("missing precision map", ["precision"])
    if "vectors" not in precision_node or "reductions" not in precision_node:
        raise _err("precision requires 'vectors' and 'reductions'", ["precision"])
    precision = PrecisionSettings(
        vector_precision=_as_str(precision_node["vectors"], ["precision", "vectors"]),
        reduction_precision=_as_str(precision_node["reductions"], ["precision", "reductions"]),
    )
    # value validation (config.cpp:339-352): only fp32/fp64 exist
    if precision.vector_precision not in ("fp32", "fp64"):
        raise _err(
            "precision.vectors must be 'fp32' or 'fp64'",
            ["precision", "vectors", precision.vector_precision],
        )
    if precision.reduction_precision not in ("fp32", "fp64"):
        raise _err(
            "precision.reductions must be 'fp32' or 'fp64'",
            ["precision", "reductions", precision.reduction_precision],
        )

    # curves (optional map) ------------------------------------------------------
    curves = {}
    curves_node = root.get("curves")
    if isinstance(curves_node, dict):
        for key, seq in curves_node.items():
            key = str(key)
            if not isinstance(seq, list) or len(seq) == 0:
                raise _err("curve must be non-empty sequence", ["curves", key])
            points: List[Tuple[float, float]] = []
            previous_time = float("-inf")
            for idx, pair in enumerate(seq):
                ctx = ["curves", key, f"[{idx}]"]
                if not isinstance(pair, (list, tuple)) or len(pair) != 2:
                    raise _err("curve point must be sequence[2]", ctx)
                t = _as_float(pair[0], ctx)
                v = _as_float(pair[1], ctx)
                if t < previous_time:
                    raise _err("curve times must be non-decreasing", ctx)
                previous_time = t
                points.append((t, v))
            curves[key] = Curve(tuple(points))

    # loads ------------------------------------------------------------------
    loads_node = root.get("loads")
    if not isinstance(loads_node, dict):
        raise _err("missing loads map", ["loads"])
    gravity = _node_to_vec3(loads_node.get("gravity"), ["loads", "gravity"])

    tractions: List[SurfaceTraction] = []
    tractions_node = loads_node.get("tractions")
    if tractions_node is not None and not isinstance(tractions_node, list):
        raise _err("loads.tractions must be a sequence when present", ["loads", "tractions"])
    if isinstance(tractions_node, list):
        for i, entry in enumerate(tractions_node):
            ctx = ["loads", "tractions", f"[{i}]"]
            if not isinstance(entry, dict):
                raise _err("traction entry must be map", ctx)
            if "group" not in entry:
                raise _err("traction requires 'group'", ctx)
            group = _as_str(entry["group"], [*ctx, "group"])
            scale_curve = (
                _as_str(entry["scale_curve"], [*ctx, "scale_curve"])
                if "scale_curve" in entry
                else ""
            )
            value = _node_to_vec3(entry.get("value"), [*ctx, "value"])
            if scale_curve and scale_curve not in curves:
                raise _err("traction references unknown curve", [*ctx, "scale_curve"])
            tractions.append(SurfaceTraction(group, value, scale_curve))

    points_loads: List[PointLoad] = []
    points_node = loads_node.get("points")
    if points_node is not None and not isinstance(points_node, list):
        raise _err("loads.points must be a sequence when present", ["loads", "points"])
    if isinstance(points_node, list):
        for i, entry in enumerate(points_node):
            ctx = ["loads", "points", f"[{i}]"]
            if not isinstance(entry, dict):
                raise _err("point load entry must be map", ctx)
            if "group" not in entry:
                raise _err("point load requires 'group'", ctx)
            group = _as_str(entry["group"], [*ctx, "group"])
            scale_curve = (
                _as_str(entry["scale_curve"], [*ctx, "scale_curve"])
                if "scale_curve" in entry
                else ""
            )
            value = _node_to_vec3(entry.get("value"), [*ctx, "value"])
            if scale_curve and scale_curve not in curves:
                raise _err("point load references unknown curve", [*ctx, "scale_curve"])
            points_loads.append(PointLoad(group, value, scale_curve))

    loads = Loads(gravity, tuple(tractions), tuple(points_loads))

    # dirichlet (optional) ---------------------------------------------------
    dirichlet: List[DirichletFix] = []
    dirichlet_node = root.get("dirichlet")
    if isinstance(dirichlet_node, dict):
        fixes_node = dirichlet_node.get("fixes")
        if isinstance(fixes_node, list):
            for i, entry in enumerate(fixes_node):
                ctx = ["dirichlet", "fixes", f"[{i}]"]
                if not isinstance(entry, dict):
                    raise _err("dirichlet fixed entry must be a map", ctx)
                if "group" not in entry:
                    raise _err("dirichlet fix requires 'group'", [*ctx, "group"])
                group = _as_str(entry["group"], [*ctx, "group"])
                dof_node = entry.get("dof")
                if not isinstance(dof_node, list):
                    raise _err("expected sequence for string list", [*ctx, "dof"])
                if len(dof_node) == 0:
                    raise _err("dirichlet.dof must not be empty", [*ctx, "dof"])
                constrain = [False, False, False]
                for axis in dof_node:
                    axis = _as_str(axis, [*ctx, "dof"])
                    if axis == "x":
                        constrain[0] = True
                    elif axis == "y":
                        constrain[1] = True
                    elif axis == "z":
                        constrain[2] = True
                    else:
                        raise _err("dirichlet.dof must be subset of {x,y,z}", [*ctx, "dof"])
                value = _node_to_optional_vec3(entry.get("value"), [*ctx, "value"])
                dirichlet.append(
                    DirichletFix(group, (constrain[0], constrain[1], constrain[2]), value)
                )

    # output -----------------------------------------------------------------
    output_node = root.get("output")
    if not isinstance(output_node, dict):
        raise _err("missing output map", ["output"])
    if "vtu_stride" not in output_node:
        raise _err("output requires 'vtu_stride'", ["output", "vtu_stride"])
    vtu_stride = _as_uint(output_node["vtu_stride"], ["output", "vtu_stride"])
    if vtu_stride == 0:
        raise _err("output.vtu_stride must be >= 1", ["output", "vtu_stride"])
    probes: List[int] = []
    probes_node = output_node.get("probes")
    if isinstance(probes_node, list):
        for i, item in enumerate(probes_node):
            probes.append(_as_uint(item, ["output", "probes", f"[{i}]"]))
    output = OutputSettings(vtu_stride, tuple(probes))

    # boundaries (extension; absent = reference-compatible behavior) ----------
    absorbing: List[str] = []
    boundaries_node = root.get("boundaries")
    if boundaries_node is not None:
        if not isinstance(boundaries_node, dict):
            raise _err("boundaries must be a map when present", ["boundaries"])
        absorbing_node = boundaries_node.get("absorbing")
        if absorbing_node is not None:
            if not isinstance(absorbing_node, list):
                raise _err(
                    "boundaries.absorbing must be a sequence of group names",
                    ["boundaries", "absorbing"],
                )
            for i, item in enumerate(absorbing_node):
                name = _as_str(item, ["boundaries", "absorbing", f"[{i}]"])
                if not name:
                    raise _err(
                        "absorbing group name must be non-empty",
                        ["boundaries", "absorbing", f"[{i}]"],
                    )
                absorbing.append(name)

    box_regions = _parse_box_regions(root.get("box_regions"), mesh_path)

    return Config(
        mesh_path=mesh_path,
        materials=tuple(materials),
        assignments=tuple(assignments),
        damping=damping,
        time=time_settings,
        solver=solver,
        precision=precision,
        loads=loads,
        curves=curves,
        dirichlet=tuple(dirichlet),
        output=output,
        absorbing=tuple(absorbing),
        box_regions=box_regions,
    )


def _parse_box_regions(node: Any, mesh_path: str) -> Tuple[BoxRegion, ...]:
    """``box_regions`` (extension; absent = no regions): named boxes of
    cells of a ``synthetic://box`` mesh, by fractions of its extent."""
    if node is None:
        return ()
    if not mesh_path.startswith(BOX_PREFIX):
        raise _err("box_regions requires a synthetic://box mesh", ["box_regions"])
    if not isinstance(node, list):
        raise _err("box_regions must be a sequence when present", ["box_regions"])
    regions: List[BoxRegion] = []
    names = set()
    for i, entry in enumerate(node):
        ctx = ["box_regions", f"[{i}]"]
        if not isinstance(entry, dict):
            raise _err("box region must be a map", ctx)
        for key in ("group", "lo", "hi"):
            if key not in entry:
                raise _err(f"box region missing required key '{key}'", ctx)
        group = _as_str(entry["group"], [*ctx, "group"])
        if not group:
            raise _err("box region group name must be non-empty", [*ctx, "group"])
        if group in BOX_GROUPS:
            raise _err("box region group name is one of the box's own groups",
                       [*ctx, "group"])
        if group in names:
            raise _err("box region group names must be unique", [*ctx, "group"])
        names.add(group)
        lo = _node_to_vec3(entry["lo"], [*ctx, "lo"])
        hi = _node_to_vec3(entry["hi"], [*ctx, "hi"])
        for key, values in (("lo", lo), ("hi", hi)):
            for a, value in enumerate(values):
                if not 0.0 <= value <= 1.0:
                    raise _err("box region fractions must be in [0, 1]",
                               [*ctx, key, f"[{a}]"])
        for a in range(3):
            if lo[a] >= hi[a]:
                raise _err("box region needs lo < hi on every axis",
                           [*ctx, "hi", f"[{a}]"])
        regions.append(BoxRegion(group, lo, hi))
    return tuple(regions)
