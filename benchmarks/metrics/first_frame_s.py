"""first_frame_s: host seconds of the first frame the program's
``Simulation.run`` steps after ``build_simulation`` (lazy loads, the
kernel library's load and, in a fresh checkout, its build), ended by a
device sync (``utils.profiling.phases["first_frame"]``)."""


def read(ctx):
    from civiwave_tpu_torch.utils import profiling

    return getattr(profiling, "phases", {}).get("first_frame")
