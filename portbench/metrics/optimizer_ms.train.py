"""Device ms per step between the CUDA events of the program's
"train.clip" and "train.optimizer" spans (`train/step.py`: the global-norm
clip, AdaptAdamW and the logit_scale clamp) in the device stretch."""
from portbench.lib import spans


def read(ctx):
    return spans.device_ms(ctx, "pretrain", ["train.clip", "train.optimizer"])
