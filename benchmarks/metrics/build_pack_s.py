"""build_pack_s: host seconds of the general path's
``pack.build_packed_model`` in the program's ``build_simulation``, ended
by a device sync (``utils.profiling.phases["pack"]``)."""


def read(ctx):
    from civiwave_tpu_torch.utils import profiling

    return getattr(profiling, "phases", {}).get("pack")
