"""Device-idle ms per image of the device stretch while the host is inside
the program's "eval.labels" span (`evalseg/inference.py`: the resize to the
original size, the arg-max and `.cpu()`; innermost span, lib/spans.py)."""
from portbench.lib import spans


def read(ctx):
    return spans.idle_ms(ctx, "zeroshot_eval", ["eval.labels"])
