"""The comparison that decides ``correct``.

The reference (``benchmarks/reference``) builds the scenario's system
again from its definition and judges the program's answers: the first
frame, from rest, and a few consecutive frames of the window, each from
the state the program had before it (the reference follows the program frame by frame;
it does not run the trajectory itself).  Per frame: the relative residual
of u_k in the reference's float64 K_eff (2-norm and largest entry) and
how far u_k and v_k lie from the Newmark update with the frame's a_k.  With output, the
window frame's probe rows against the captured state (u, v, a) and the
reference's derived fields of that u_k (strain, stress, von Mises).
"""

from __future__ import annotations

import csv
import math

import torch

from benchmarks.reference import solve
from benchmarks.reference.derived import node_fields
from benchmarks.reference.newmark import build_system, judge as judge_frame

# probe CSV column groups: (first, last + 1)
PROBE_GROUPS = {"u": (0, 3), "v": (3, 6), "a": (6, 9), "strain": (9, 15),
                "stress": (15, 21), "von_mises": (21, 22)}


def read_probe_rows(path: str, frame: int) -> dict:
    """{node: [22 values]} of ``frame``'s rows in the program's probe CSV."""
    rows = {}
    with open(path, encoding="ascii") as f:
        for row in csv.DictReader(f):
            if int(row["frame"]) == frame:
                values = list(row.values())[3:]
                rows[int(row["node"])] = [float(v) for v in values]
    return rows


def probe_gap(system, after, rows: dict, device) -> float:
    """Largest gap of the probe rows, per column group, over the largest
    entry of the group's expected values."""
    nodes = sorted(rows)
    got = torch.tensor([rows[n] for n in nodes], dtype=torch.float64)
    u, v, a = after
    idx = torch.tensor(nodes)
    fields = node_fields(system, u.to(device), nodes).cpu()
    want = torch.cat([u[idx], v[idx], a[idx], fields], dim=1)
    gap = 0.0
    for lo, hi in PROBE_GROUPS.values():
        scale = float(want[:, lo:hi].abs().max())
        diff = float((got[:, lo:hi] - want[:, lo:hi]).abs().max())
        gap = max(gap, diff / scale if scale > 0 else diff)
    return gap


def control_answers(system, node: dict, answers: dict, probe_rows, dtype):
    """The control: the reference put in the program's place, computed in
    ``dtype`` (bfloat16 below the configuration's float32): each frame
    solved from the same state before it, and the probe rows' derived
    fields worked out from that frame's u."""
    solver = node["solver"]
    out = {}
    for label, (before, after, frame) in answers.items():
        start = before if before is not None else [torch.zeros_like(t) for t in after]
        state, _ = solve.frame(system, start, frame * system.dt, dtype,
                               float(solver["tol_runtime"]), int(solver["max_iters"]))
        out[label] = (before, [t.to("cpu", torch.float64) for t in state], frame)
    if probe_rows is not None:
        u, v, a = out["w0"][1]
        nodes = sorted(probe_rows)
        idx = torch.tensor(nodes)
        fields = node_fields(system, u.to(system.device, dtype), nodes).cpu().double()
        rows = torch.cat([u[idx], v[idx], a[idx], fields], dim=1)
        probe_rows = {n: rows[i].tolist() for i, n in enumerate(nodes)}
    return out, probe_rows


def judge(node: dict, traffic, answers: dict, probe_rows, device,
          control_dtype=None, config=None) -> dict:
    """{number name: value}; ``answers`` maps a label to (state before or
    None for rest, state after, frame index).  ``config`` names the
    configuration, whose own material layout the reference takes where it
    has one (``benchmarks/reference/materials``).  With ``control_dtype``
    the answers judged are the control's (``control_answers``)."""
    system = build_system(node, traffic.dt, traffic.curve, device, config)
    if control_dtype is not None:
        answers, probe_rows = control_answers(system, node, answers, probe_rows,
                                              control_dtype)
    numbers = {}
    for label, (before, after, frame) in answers.items():
        if before is None:
            before = [torch.zeros_like(t) for t in after]
        for name, value in judge_frame(system, before, after, frame * traffic.dt).items():
            numbers[f"{name}.{label}"] = value
    if probe_rows is not None:
        if not probe_rows:
            numbers["probe_gap.w0"] = math.inf  # the frame wrote no rows
        else:
            numbers["probe_gap.w0"] = probe_gap(
                system, answers["w0"][1], probe_rows, device)
    return numbers


def compare(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): each number against the
    limit of its kind (the name before the dot), a key of the cell's limits
    file; a kind the file gives no limit is not compared there (the file
    also says how many window frames are checked)."""
    compared = {}
    correct = True
    for name, value in numbers.items():
        kind = name.split(".")[0]
        if kind not in limits:
            continue
        limit = float(limits[kind])
        compared[name] = {"value": value, "limit": limit}
        if not (math.isfinite(value) and value <= limit):
            correct = False
    return correct, compared
