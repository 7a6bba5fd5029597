"""Process start to the first timed step: imports, the kernel library's
load (or build), data made and handed to the program, the program's set-up,
the first steps that the correctness check follows, and the warm-up."""


def read(ctx):
    return ctx.setup_s
