"""Device microseconds a step of what was launched inside the program's
``fps.compute`` ranges (the model's step) in the traced stretch."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    s = t["by_range"].get("fps.compute", 0.0)
    return s * 1e6 / ctx.work["steps"] if s > 0 else None
