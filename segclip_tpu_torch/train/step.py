"""The training step (segclip_tpu/train/step.py), on one device.

One step, in the reference's order (main_task_align.py:292-359):
  uint8 images → CLIP-normalised on the device → forward (the loss dict)
  → backward, `grad_accum_steps` micro-batches averaged → global-norm clip
  → NaN-loss skip (the optimizer, its step counter and the parameters stay
  untouched; the state's step still advances) → AdaptAdamW → the clamp of
  logit_scale at ≤ ln 100.

The Gumbel and masking noise comes from a torch.Generator on the device,
seeded by (seed, step), so a step is reproducible on one device; it is not
the JAX package's stream (tests inject the same noise into both). The model
and the optimizer are updated in place; `TrainState` carries the step and
the seed. Frozen parameters have requires_grad=False (param_groups.freeze),
so they get no gradient and no share of the clip norm, as the JAX step's
stop_gradient gives them none.

The rgb transport only: the YUV transport and device-side augmentation of
the JAX step are not ported (ROADMAP).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from segclip_tpu_torch.config import Config
from segclip_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD
from segclip_tpu_torch.models.segclip import SegCLIP
from segclip_tpu_torch.train.optimizer import AdaptAdamW, global_norm_clip
from segclip_tpu_torch.train.param_groups import freeze, param_groups

LOGIT_SCALE_MAX = math.log(100.0)
BATCH_KEYS = ("input_ids", "attention_mask", "image", "image_seg",
              "text_class", "scene_classes")


@dataclass
class TrainState:
    step: int = 0
    seed: int = 0


def create_optimizer(model: SegCLIP, cfg: Config, t_total: int) -> AdaptAdamW:
    """Freeze the parameters the freeze passes name (requires_grad=False)
    and build AdaptAdamW over the rest, in the 8 reference groups."""
    o = cfg.optim
    freeze(model, o, first_stage_layer=cfg.model.first_stage_layer)
    return AdaptAdamW(param_groups(model, o), t_total=t_total,
                      warmup=o.warmup_proportion, schedule=o.schedule, b1=o.b1,
                      b2=o.b2, eps=o.eps, lr_start=o.lr_start, lr_end=o.lr_end,
                      moment_dtype=o.moment_dtype)


def normalize_images(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """uint8 images (B, H, W, 3) → CLIP-normalised float32 on their device;
    float images are taken as already normalised."""
    image = batch["image"]
    if image.dtype != torch.uint8:
        return batch
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=image.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=image.device)
    return {**batch, "image": (image.float() / 255.0 - mean) / std}


def step_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """The step's generator: a function of (seed, step) only."""
    if not 0 <= seed < 2 ** 31 or not 0 <= step < 2 ** 32:
        raise ValueError(f"seed {seed} or step {step} out of range")
    return torch.Generator(device=device).manual_seed((seed << 32) | step)


def make_train_step(model: SegCLIP, optimizer: AdaptAdamW, cfg: Config
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """step(state, batch, noise=None) → metrics: the loss dict (averaged
    over micro-batches) plus "grad_norm" and "skipped_nan", as 0-d tensors.
    Updates the model, the optimizer and state.step in place. `noise` (the
    keys of models.segclip.NOISE_KEYS, at micro-batch size) replaces the
    draws in every micro-batch; it is for tests."""
    accum = cfg.train.grad_accum_steps
    max_norm = cfg.optim.max_grad_norm
    params = [p for p in model.parameters() if p.requires_grad]
    logit_scale = model.clip.logit_scale

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             noise: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        batch = normalize_images({k: v for k, v in batch.items() if v is not None})
        b = batch["image"].shape[0]
        if accum < 1 or b % accum:
            raise ValueError(f"batch {b} does not split into {accum} micro-batches")
        gen = step_generator(batch["image"].device, state.seed, state.step)
        for p in params:
            p.grad = None
        sums: Dict[str, torch.Tensor] = {}
        for micro in range(accum):
            lo, hi = micro * b // accum, (micro + 1) * b // accum
            mb = {k: v[lo:hi] for k, v in batch.items() if k in BATCH_KEYS}
            losses = model(mb["input_ids"], mb["attention_mask"], mb["image"],
                           mb.get("image_seg"), training=True,
                           text_class=mb.get("text_class"),
                           scene_classes=mb.get("scene_classes"),
                           noise=noise, generator=gen)
            losses["loss"].backward()
            for k, v in losses.items():
                sums[k] = sums.get(k, 0) + v.detach()
        metrics = {k: v / accum for k, v in sums.items()}
        if accum > 1:
            for p in params:
                if p.grad is not None:
                    p.grad.div_(accum)

        metrics["grad_norm"] = global_norm_clip(params, max_norm)
        skipped = bool(torch.isnan(metrics["loss"]))
        if not skipped:
            optimizer.step()
            with torch.no_grad():
                logit_scale.copy_(torch.minimum(
                    logit_scale, torch.full_like(logit_scale, LOGIT_SCALE_MAX)))
        metrics["skipped_nan"] = torch.tensor(float(skipped))
        state.step += 1
        return metrics

    return step
