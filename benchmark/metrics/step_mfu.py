"""The whole step's least time over its measured time (%).

The least time is the larger of the step's FLOPs over the card's float32
peak and its least bytes over its peak bandwidth, from the traced stretch's
steps; the measured time is the untraced window's seconds a step."""


def read(ctx):
    w, work = ctx.window, ctx.work
    if work is None or not w or not w["steps"] or not ctx.trace or not \
            ctx.trace["device_ops"]:
        return None
    steps = work["steps"]
    flops_s = work["step_flops"] / steps / ctx.peaks["fp32_flops_per_s"]
    bytes_s = work["step_bytes"] / steps / ctx.peaks["hbm_bytes_per_s"]
    ctx.notes["step_mfu_bound"] = "flops" if flops_s > bytes_s else "bytes"
    least = max(flops_s, bytes_s)
    if least <= 0:
        return None
    return 100.0 * least / (w["seconds"] / w["steps"])
