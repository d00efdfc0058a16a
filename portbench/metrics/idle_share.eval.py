"""The share of an image's time in which the device runs nothing, in %:
one minus the device's busy time per image in the device stretch (the
union of its kernels, copies and sets) over the mean host-clock time per
image of the window's unprofiled groups. The stretch's own length is not
the denominator: even a device-only profile adds host time to every
launch."""


def read(ctx):
    summary = ctx.get("summary") if ctx.get("kind") == "zeroshot_eval" else None
    calls = ctx.get("call_s")
    if summary is None or summary.busy_s <= 0 or not calls or not ctx.get("units_profiled"):
        return None
    busy = summary.busy_s / ctx["units_profiled"]
    return 100.0 * (1.0 - busy / (sum(calls) / len(calls) / ctx["images_per_call"]))
