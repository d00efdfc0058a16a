"""Checkpoints of the training state with torch.save (the directory names
and API of segclip_tpu/checkpoint/orbax_io.py).

    <output_dir>/ckpt_epoch_<N>/model.pt        the reference-layout state dict
    <output_dir>/ckpt_epoch_<N>/train_state.pt  optimizer state and counters

`model.pt` is `SegCLIP.state_dict()` on the CPU, the reference's key layout,
so the eval CLI's `--init-model` and `checkpoint/convert.load_into` read it
as it is. `train_state.pt` holds `optimizer.state_dict()`, the optimizer's
shared step counter `step_count` (AdaptAdamW keeps it outside
`state_dict()`), `TrainState.step` and `.seed`, and the epoch. The two step
counters are stored apart because a NaN-skipped step advances the first
and not the second. A directory is written whole under a temporary name and
then renamed, so a crash leaves the previous checkpoint as it was.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional, Tuple

import torch

from segclip_tpu_torch.train.optimizer import AdaptAdamW
from segclip_tpu_torch.train.step import TrainState

MODEL_FILE = "model.pt"
TRAIN_STATE_FILE = "train_state.pt"


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def save_checkpoint(output_dir: str, epoch: int, model: torch.nn.Module,
                    optimizer: AdaptAdamW, state: TrainState,
                    max_kept: int = -1, name: Optional[str] = None) -> str:
    """Save the training state under <output_dir>/<name or ckpt_epoch_<epoch>>.

    `name` overrides the directory name (e.g. "ckpt_best" for
    train.keep_best — kept outside the ckpt_epoch_* namespace so auto-resume
    and GC never touch it); the payload's epoch still records which epoch
    produced it."""
    path = os.path.join(_abs(output_dir), name or f"ckpt_epoch_{epoch}")
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(tmp, MODEL_FILE))
    torch.save({"optimizer": optimizer.state_dict(),
                "optimizer_step_count": optimizer.step_count,
                "step": state.step, "seed": state.seed, "epoch": epoch},
               os.path.join(tmp, TRAIN_STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    if max_kept > 0:
        _gc_old(output_dir, max_kept)
    return path


def _list_ckpts(output_dir: str):
    root = _abs(output_dir)
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        if d.startswith("ckpt_epoch_"):
            try:
                out.append((int(d.rsplit("_", 1)[1]), os.path.join(root, d)))
            except ValueError:
                continue
    return sorted(out)


def _gc_old(output_dir: str, max_kept: int) -> None:
    for _, path in _list_ckpts(output_dir)[:-max_kept]:
        shutil.rmtree(path, ignore_errors=True)


def auto_resume_path(output_dir: str) -> Optional[str]:
    """Latest checkpoint dir, or None (auto_resume_helper equivalent)."""
    ckpts = _list_ckpts(output_dir)
    return ckpts[-1][1] if ckpts else None


def restore_checkpoint(path: str, model: torch.nn.Module, optimizer: AdaptAdamW,
                       state: TrainState) -> Tuple[TrainState, int]:
    """Load a checkpoint into `model` and `optimizer` in place (each onto
    the device and dtype of its parameters and moments); returns the
    restored TrainState and the epoch that wrote the checkpoint."""
    path = _abs(path)
    device = next(model.parameters()).device
    model.load_state_dict(torch.load(os.path.join(path, MODEL_FILE),
                                     map_location=device, weights_only=True))
    saved = torch.load(os.path.join(path, TRAIN_STATE_FILE),
                       map_location=device, weights_only=True)
    optimizer.load_state_dict(saved["optimizer"])
    # Optimizer.load_state_dict casts the moments to the parameters' dtype;
    # AdaptAdamW stores them in its own moment_dtype.
    for moments in optimizer.state.values():
        for key in ("exp_avg", "exp_avg_sq"):
            if key in moments:
                moments[key] = moments[key].to(optimizer.moment_dtype)
    optimizer.step_count = int(saved["optimizer_step_count"])
    return TrainState(step=int(saved["step"]), seed=int(saved["seed"])), int(saved["epoch"])
