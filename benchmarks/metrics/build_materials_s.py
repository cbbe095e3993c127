"""build_materials_s: host seconds of the structured route's per-cell
material fields (a box's ``box_regions`` bound to materials, built on the
device) in the program's ``build_simulation``, ended by a device sync
(``utils.profiling.phases["materials"]``).  None where the program has no
such phase."""


def read(ctx):
    from civiwave_tpu_torch.utils import profiling

    return getattr(profiling, "phases", {}).get("materials")
