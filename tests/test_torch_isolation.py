"""The PyTorch port stands without JAX, and its kernel wrappers never leave
the device they were given.

A fresh interpreter imports segclip_tpu_torch, runs a tiny encode_image,
encode_text and predict on the CPU, and must end with neither jax nor flax
in sys.modules.
"""
import os
import subprocess
import sys

import pytest
import torch

from segclip_tpu_torch.ops.kernels.attention import attention
from segclip_tpu_torch.ops.kernels.grouping import group_assign
from segclip_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
import numpy as np
import torch
from segclip_tpu_torch.models.segclip import ModelConfig, init_segclip
from segclip_tpu_torch.evalseg.inference import ZeroShotSegmenter

torch.set_num_threads(1)
cfg = ModelConfig(image_resolution=32, vision_patch_size=8, vision_width=64,
                  vision_layers=4, first_stage_layer=3, group_num=4,
                  cross_layer=1, context_length=16, vocab_size=512,
                  transformer_width=64, transformer_layers=2, embed_dim=32,
                  compute_dtype="float32")
model = init_segclip(cfg, seed=0)
img = np.random.default_rng(0).normal(size=(40, 48, 3)).astype(np.float32)
with torch.no_grad():
    vis = model.encode_image(torch.from_numpy(img[None, :32, :32]))
    txt = model.encode_text(torch.tensor([[509, 7, 8, 511] + [0] * 12]))
bank = torch.nn.functional.normalize(torch.randn(5, 32), dim=-1)
seg = ZeroShotSegmenter(model, bank, with_bg=True, bg_thresh=0.5,
                        patch_size=8, crop_size=32, stride=32)
pred = seg.predict(img, (40, 48), mode="slide")
assert vis.pooled.shape == (1, 32) and txt.pooled.shape == (1, 32)
assert pred.shape == (40, 48) and 0 <= pred.min() and pred.max() <= 5
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax"))
print("LEAKED", leaked)
sys.exit(1 if leaked else 0)
"""


def test_port_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_cuda_device_without_a_card_raises():
    """A CUDA device that is not there is an error, never a quiet move to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; tests/test_torch_kernels.py "
                    "runs the kernels on it")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(1, device="cuda")


@pytest.mark.parametrize("device", ["meta", "cpu:mixed"])
def test_wrappers_take_the_plain_version_only_on_cpu(device):
    """Only CPU tensors reach the plain versions; a tensor on another
    device, or operands split across devices, raise instead of falling
    back."""
    def make(*shape):
        return torch.zeros(*shape, device="meta" if device == "meta" else "cpu")

    q, k, v = make(1, 4, 64), make(1, 4, 64), make(1, 4, 64)
    gq = make(1, 2, 64)
    if device == "cpu:mixed":
        v = torch.zeros(1, 4, 64, device="meta")
    with pytest.raises(ValueError):
        attention(q, k, v)
    with pytest.raises(ValueError):
        group_assign(gq, k, v)
    assert attention.launches == 0 and group_assign.launches == 0
