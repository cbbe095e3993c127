"""stepper_update_roofline: the Newmark stepper's three vector passes
(``csrc/newmark_vectors.cu``) on the structured grid: their summed least
time over their summed device time, over the launches the profiler
recorded, in percent of the published H100 peaks.  None where none of the
three launched (a program without them, a run on the CPU).

Least work a node, each input byte read once and each output byte written
once, 12 B a value-triple of an f32 vector (24 in f64), the f32 mass 4 B
and the 1-byte mask per component (3 B):

* ``newmark_rhs_kernel``: reads u, v, a, f and the mass, writes u_pred, d
  and rhs: 88 B, 57 operations (19 a component);
* ``newmark_rhs_clamp_kernel``: reads rhs, K d where beta_R is not 0 and an
  absorbing term where the model has one, and the mask (bc_value is read
  only at constrained components and is not charged), writes rhs: 39 B
  with K d alone, 6 operations;
* ``newmark_update_kernel``: reads x, u_pred, v, a, writes u, v, a, and
  delta under the "delta" warm-start policy (12 B more): 84 B, 21
  operations.

The kernels' template arguments name the instance: the vector type first
and, last, the clamp's two flags (K d, absorbing term) or the update's one
(delta)."""

import re

from benchmarks.harness.work import least_seconds

_NAME = re.compile(
    r"(newmark_rhs_kernel|newmark_rhs_clamp_kernel|newmark_update_kernel)<([^<>]*)>")


def least_work(kernel: str, args: list, nodes: int) -> tuple:
    """(least bytes, operations) of one launch over ``nodes`` nodes of the
    instance with template arguments ``args`` (as strings)."""
    vec = 24 if args and args[0] == "double" else 12  # a node of one vector
    if kernel == "newmark_rhs_kernel":
        return (7 * vec + 4) * nodes, 57 * nodes
    if kernel == "newmark_rhs_clamp_kernel":
        added = sum(a == "true" for a in args[-2:])
        return (2 * vec + vec * added + 3) * nodes, 6 * nodes
    return (7 * vec + vec * (args[-1] == "true")) * nodes, 21 * nodes


def read(ctx):
    if ctx.trace is None:
        return None
    least = device = 0.0
    for name, (us, launches) in ctx.trace.kernels.items():
        match = _NAME.search(name)
        if match is None or launches == 0:
            continue
        args = [a.strip() for a in match.group(2).split(",")]
        work = least_work(match.group(1), args, ctx.box.node_count)
        least += launches * least_seconds(*work)
        device += us / 1e6
    if least == 0 or device <= 0:
        return None
    return 100.0 * least / device
