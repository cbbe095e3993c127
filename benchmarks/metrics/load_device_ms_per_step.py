"""load_device_ms_per_step: device time of the kernels and copies launched
inside the program's ``load_update`` range (``Simulation._force_at`` and
``set_external_force``, runner.py), per traced frame.  On the general path
93-95 % of it is the load's upload from pageable host memory, whose length
on the device follows CUDA's staging through host memory, so the
number follows host staging and spreads from run to run (0.32-0.48 ms
over six tet-66 runs on one H100, against ~0.1 ms for the same bytes from
pinned memory)."""


def read(ctx):
    if ctx.trace is None or not ctx.frames:
        return None
    row = ctx.trace.ranges.get("load_update")
    if row is None or row[1] <= 0:
        return None
    return row[1] / 1e3 / ctx.frames
