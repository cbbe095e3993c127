"""build_preprocess_s: host seconds of the general path's
``preprocess.run`` in the program's ``build_simulation``
(``utils.profiling.phases["preprocess"]``)."""


def read(ctx):
    from civiwave_tpu_torch.utils import profiling

    return getattr(profiling, "phases", {}).get("preprocess")
