"""The pretraining step's model FLOPs (the forward's products, three
times; recompute not counted) over the mean step time of the window and
989 TFLOP/s, in %."""
from portbench.lib.work import PEAK_FLOPS


def read(ctx):
    steps = ctx.get("step_s") if ctx.get("kind") == "pretrain" else None
    if not steps:
        return None
    return 100.0 * ctx["model_flops"] / (sum(steps) / len(steps)) / PEAK_FLOPS["bfloat16"]
