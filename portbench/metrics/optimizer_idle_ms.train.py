"""Device-idle ms per step of the device stretch while the host is inside
the program's "train.clip", "train.nan_check" or "train.optimizer" span
(the innermost span open over each part of a gap; lib/spans.py)."""
from portbench.lib import spans


def read(ctx):
    return spans.idle_ms(ctx, "pretrain", ["train.clip", "train.nan_check", "train.optimizer"])
