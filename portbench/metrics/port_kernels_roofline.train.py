"""The least time the attention and grouping work of the device stretch's
steps could take (counted from the logical calls' shapes, lib/work.py), over the
device time of the port's kernels that did it, in %."""


def read(ctx):
    summary = ctx.get("summary") if ctx.get("kind") == "pretrain" else None
    if summary is None or not ctx.get("units_profiled"):
        return None
    seconds = summary.device_seconds(port=True)
    if seconds <= 0:
        return None
    return 100.0 * ctx["port_least_s"] * ctx["units_profiled"] / seconds
