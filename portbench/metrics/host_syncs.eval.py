"""The program's host syncs per image: its "host_syncs" counter over its
"eval.images" counter (`utils/profiling.count`), over the run."""
from portbench.lib import spans


def read(ctx):
    return spans.per(ctx, "zeroshot_eval", "host_syncs", "eval.images")
