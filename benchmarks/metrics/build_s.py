"""build_s: wall seconds of the program's ``build_simulation`` (runner.py),
ended by a device sync; host clock."""


def read(ctx):
    return ctx.build_s
