"""The 95th percentile of the window's step times on the host clock, each
ending at the step's own sync (its NaN check), in ms; the profiled steps
left out."""
import statistics


def read(ctx):
    steps = ctx.get("step_s") if ctx.get("kind") == "pretrain" else None
    if not steps or len(steps) < 2:
        return None
    return 1e3 * statistics.quantiles(steps, n=20, method="inclusive")[18]
