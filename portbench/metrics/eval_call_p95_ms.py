"""The 95th percentile of the host time from one group's predict_batch to
the next (the decode, the labels, the mIoU meter's updates, the next
group's loads), in ms; the profiled groups left out."""
import statistics


def read(ctx):
    calls = ctx.get("call_s") if ctx.get("kind") == "zeroshot_eval" else None
    if not calls or len(calls) < 2:
        return None
    return 1e3 * statistics.quantiles(calls, n=20, method="inclusive")[18]
