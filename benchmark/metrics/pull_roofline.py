"""The least bytes of the traced stretch's pulls over the device time of
what was launched inside the program's ``fps.pull`` ranges, as a share of
the card's peak memory bandwidth (%)."""

RANGES = ("fps.pull",)


def read(ctx):
    return ctx.roofline("pull_bytes", RANGES)
