"""Device ms per image of the port's own kernels (`segclip_kernels::`:
attention and grouping) in the device stretch."""


def read(ctx):
    summary = ctx.get("summary") if ctx.get("kind") == "zeroshot_eval" else None
    if summary is None or not ctx.get("units_profiled"):
        return None
    seconds = summary.device_seconds(port=True)
    return 1e3 * seconds / ctx["units_profiled"] if seconds > 0 else None
