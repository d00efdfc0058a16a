"""Interpolation matrices built on the host per image: the program's
"interp_builds" counter (`ops/pos_embed.interp_tensor`) over its
"eval.images" counter, over the run."""
from portbench.lib import spans


def read(ctx):
    return spans.per(ctx, "zeroshot_eval", "interp_builds", "eval.images")
