"""Device operations (kernels, copies, memsets) a step in the traced
stretch: what the host enqueues for the device each step."""


def read(ctx):
    t = ctx.trace
    if t is None or not t["device_ops"]:
        return None
    return t["device_ops"] / ctx.work["steps"]
