"""Device ms per step between the CUDA events of the program's
"train.forward" spans (`train/step.py`) in the device stretch."""
from portbench.lib import spans


def read(ctx):
    return spans.device_ms(ctx, "pretrain", ["train.forward"])
