"""The program's host syncs per training step: its "host_syncs" counter
over its "train.steps" counter (`utils/profiling.count`), over the run."""
from portbench.lib import spans


def read(ctx):
    return spans.per(ctx, "pretrain", "host_syncs", "train.steps")
