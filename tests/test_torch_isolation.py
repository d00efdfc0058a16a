"""The PyTorch port stands without JAX and without the JAX package, its
entry points run on the card unless the CPU is named, and its kernel
wrappers never leave the device they were given.

A fresh interpreter imports only segclip_tpu_torch, runs a tiny
encode_image, encode_text and predict, and a tiny training step on a batch
of each transport, on the CPU, imports the loop, the train CLI and
prepare_data and runs the native superpixels, loads a checkpoint and an Orbax directory (the
port's own writer and reader) through load_model and imports the demo,
the process-group plumbing and tensor parallelism, the sharded evaluator, the five studies and
the profiling helpers, and must end with no module of segclip_tpu, jax, flax, orbax, tensorstore or
zstandard in sys.modules. An AST scan holds every file of the port, and
chip_smoke.py, to importing none of them, and the studies to
importing no cv2 (the card's machine need not have OpenCV).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

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
from segclip_tpu_torch.config import Config, ModelConfig
from segclip_tpu_torch.models.segclip import init_segclip
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

from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step
cfg = Config(model=ModelConfig(**{**cfg.__dict__, "max_words": 16,
                                  "mae_decoder_depth": 1, "mae_decoder_num_heads": 2}))
model = init_segclip(cfg.model, seed=0)
step = make_train_step(model, create_optimizer(model, cfg, t_total=10), cfg)
rng = np.random.default_rng(0)
ids = np.zeros((2, 16), np.int64)
ids[:, 0], ids[:, 1:4], ids[:, 4] = 509, rng.integers(1, 500, (2, 3)), 511
batch = {"input_ids": torch.from_numpy(ids), "attention_mask": torch.from_numpy(ids != 0).long(),
         "image": torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)),
         "image_seg": torch.from_numpy(rng.integers(0, 4, (2, 4, 4)))}
metrics = step(TrainState(), batch)
assert np.isfinite(float(metrics["loss"])) and float(metrics["skipped_nan"]) == 0.0
yuv = {**batch, "image_y": batch["image"][..., 0], "image_cbcr": batch["image"][:, ::2, ::2, :2]}
del yuv["image"]
aug = {**batch, "image": torch.zeros(2, 32, 64, 3, dtype=torch.uint8),
       "image_window": torch.tensor([[3, 2, 40, 28], [1, 0, 20, 30]]),
       "image_transposed": torch.tensor([0, 1], dtype=torch.uint8)}
for b in (yuv, aug):
    assert np.isfinite(float(step(TrainState(), b)["loss"]))

import segclip_tpu_torch.cli.prepare_data, segclip_tpu_torch.cli.train
import segclip_tpu_torch.train.loop
import segclip_tpu_torch.cli.demo, segclip_tpu_torch.cli.eval_zeroshot
import segclip_tpu_torch.evalseg.visualize, segclip_tpu_torch.parallel.dist
import segclip_tpu_torch.parallel.gspmd
from segclip_tpu_torch.evalseg.inference import evaluate_dataset_sharded
import segclip_tpu_torch.studies.classprobe, segclip_tpu_torch.studies.spatial_margin_probe
import segclip_tpu_torch.studies.holdout_study, segclip_tpu_torch.studies.eval_ipd_study
import segclip_tpu_torch.studies.host_stage_bench
from segclip_tpu_torch.utils.profiling import count, counters, span, spans
import os, tempfile
from segclip_tpu_torch.cli.common import load_model
from segclip_tpu_torch.checkpoint import orbax_io
with tempfile.TemporaryDirectory() as tmp:
    torch.save(model.state_dict(), os.path.join(tmp, "model.pt"))
    orbax_io.save_params(tmp, "params", model.state_dict())
    for init in ("model.pt", "params"):
        loaded, inferred = load_model(os.path.join(tmp, init), cfg.model, torch.device("cpu"))
        assert inferred == cfg.model
        assert all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(),
                                                      model.state_dict().values()))
from segclip_tpu_torch.data.superpixel import felzenszwalb
assert felzenszwalb(rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)).shape == (16, 16)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("segclip_tpu", "jax", "flax", "orbax", "tensorstore",
                                       "zstandard"))
print("LEAKED", leaked)
sys.exit(1 if leaked else 0)
"""


def test_port_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def _imported_modules(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_port_files_import_nothing_of_the_jax_package():
    """Every module of the port, and chip_smoke.py, at any depth (inside
    functions too): no `import segclip_tpu...` and no `from segclip_tpu...`
    (the port keeps its own copies, tests/test_torch_vendored.py)."""
    files = sorted(Path(REPO, "segclip_tpu_torch").rglob("*.py")) + [
        Path(REPO, "chip_smoke.py")]
    assert len(files) > 30
    offenders = {str(f.relative_to(REPO)): sorted(bad) for f in files
                 if (bad := {m for m in _imported_modules(f)
                             if m.split(".")[0] in ("segclip_tpu", "jax", "flax", "orbax",
                                                    "tensorstore", "zstandard")})}
    assert offenders == {}


def test_studies_import_no_cv2():
    """The studies reproduce cv2's resize themselves: no module under
    studies/ imports cv2, at any depth."""
    files = sorted(Path(REPO, "segclip_tpu_torch", "studies").rglob("*.py"))
    assert len(files) >= 5
    offenders = {str(f.relative_to(REPO)) for f in files
                 if any(m.split(".")[0] == "cv2" for m in _imported_modules(f))}
    assert offenders == set()


def test_cuda_device_without_a_card_raises():
    """A CUDA device that is not there is an error, never a quiet move to
    the CPU: by name, and by default (no name means the card)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; tests/test_torch_kernels.py "
                    "runs the kernels on it")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(1, device="cuda")


def test_resolve_device_gives_the_cpu_when_named():
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


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
