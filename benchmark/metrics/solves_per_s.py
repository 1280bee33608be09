"""solves_per_s: scenarios solved over the window, from the first call's
submission to the synchronize after the last call the window started (host
clock): all the work over all the time."""


def read(ctx):
    w = ctx.window
    if ctx.cell.traffic["loop"] != "batched" or w["seconds"] <= 0:
        return None
    return w["scenarios"] / w["seconds"]
