"""Examples trained in the untraced window over all its seconds.

An example is what the configuration's family counts as one: a rating, or a
raw token of the epoch's stream. The window ends at an epoch boundary and a
synchronise, so every example counted has been trained."""


def read(ctx):
    w = ctx.window
    if not w or w["seconds"] <= 0:
        return None
    return w["examples"] / w["seconds"]
