"""Device ms per step between the CUDA events of the program's
"train.backward" spans (`train/step.py`) in the device stretch; under
model.remat the blocks' recomputed forwards are part of it."""
from portbench.lib import spans


def read(ctx):
    return spans.device_ms(ctx, "pretrain", ["train.backward"])
