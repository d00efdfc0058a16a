"""Device ms per image of every kernel, copy and set in the device
stretch that is not the port's own (cuBLAS, ATen, copies)."""


def read(ctx):
    summary = ctx.get("summary") if ctx.get("kind") == "zeroshot_eval" else None
    if summary is None or not ctx.get("units_profiled"):
        return None
    seconds = summary.device_seconds(port=False)
    return 1e3 * seconds / ctx["units_profiled"] if seconds > 0 else None
