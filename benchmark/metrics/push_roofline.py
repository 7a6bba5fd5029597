"""The least bytes of the traced stretch's pushes over the device time of
what was launched inside the program's ``fps.push`` and
``fps.hot_accumulate`` ranges, as a share of the card's peak memory
bandwidth (%)."""

RANGES = ("fps.push", "fps.hot_accumulate")


def read(ctx):
    return ctx.roofline("push_bytes", RANGES)
