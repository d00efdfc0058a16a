"""Device-idle ms per image of the device stretch while the host is inside
the program's "eval.load" or "eval.prep" span (the dataset's load; the slide
windows, their stack and the copy to the card)."""
from portbench.lib import spans


def read(ctx):
    return spans.idle_ms(ctx, "zeroshot_eval", ["eval.load", "eval.prep"])
