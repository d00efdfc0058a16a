"""What the studies share: the model configuration they start from, the
device and the model, and the report."""
from __future__ import annotations

import json
import time
from typing import Optional, Sequence, Tuple

import torch

from segclip_tpu_torch.cli.common import load_model
from segclip_tpu_torch.config import ModelConfig, apply_overrides
from segclip_tpu_torch.models.segclip import SegCLIP, check_kernel_fields
from segclip_tpu_torch.utils.device import resolve_device
from segclip_tpu_torch.utils.logging import get_logger

# The from-scratch shapes recipe's switches, every study's starting point
# before the checkpoint's shapes and the --opts overrides.
STUDY_MODEL = dict(use_vision_mae_recon=True, use_seglabel=True, gumbel_tau=3.0,
                   group_balance_weight=1.0)


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N, or cpu; the CPU runs the kernels' "
                         "plain versions and is used only when named")


def load_study_model(ckpt: Optional[str], device_name: str, opts: Sequence[str] = (),
                     **fields) -> Tuple[SegCLIP, ModelConfig, torch.device]:
    """The device (TF32 off), and the model from `ckpt` (a torch checkpoint;
    None: the seeded random init) on it, in eval mode."""
    device = resolve_device(device_name)
    cfg = apply_overrides(ModelConfig(**STUDY_MODEL, **fields), list(opts))
    check_kernel_fields(cfg, get_logger().info)
    t0 = time.perf_counter()
    model, cfg = load_model(ckpt, cfg, device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host"
    print(f"device {device} ({name}); model {cfg.compute_dtype}, loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    return model, cfg, device


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def write_report(report: dict, out: Optional[str]) -> None:
    """The report on stdout, and at `out` when given."""
    print(json.dumps(report, indent=2))
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=2)
