"""Device-idle ms per image of the device stretch while the host is inside
the program's "eval.meter" span (the mIoU meter's update, on the host)."""
from portbench.lib import spans


def read(ctx):
    return spans.idle_ms(ctx, "zeroshot_eval", ["eval.meter"])
