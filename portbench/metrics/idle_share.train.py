"""The share of a step in which the device runs nothing, in %: one minus
the device's busy time per step in the device stretch (the union of its
kernels, copies and sets) over the mean host-clock time of the window's
unprofiled steps. The stretch's own length is not the denominator: even a
device-only profile adds host time to every launch."""


def read(ctx):
    summary = ctx.get("summary") if ctx.get("kind") == "pretrain" else None
    steps = ctx.get("step_s")
    if summary is None or summary.busy_s <= 0 or not steps or not ctx.get("units_profiled"):
        return None
    busy = summary.busy_s / ctx["units_profiled"]
    return 100.0 * (1.0 - busy / (sum(steps) / len(steps)))
