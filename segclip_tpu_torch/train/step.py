"""The training step (segclip_tpu/train/step.py), on one device or data
parallel across processes.

One step, in the reference's order (main_task_align.py:292-359):
  uint8 images (any of the pipeline's three transports) → RGB at the
  model's resolution, CLIP-normalised on the device → forward (the loss dict)
  → backward, `grad_accum_steps` micro-batches averaged → global-norm clip
  → NaN-loss skip (the optimizer, its step counter and the parameters stay
  untouched; the state's step still advances) → AdaptAdamW → the clamp of
  logit_scale at ≤ ln 100.

Data parallel (a process group of several ranks, parallel/dist.py), as the
JAX package's sharded step: each rank runs its shard of the global batch,
the InfoNCE gathers features across ranks (parallel/collectives.py), the
gradients and the losses are averaged across ranks (its `pmean`) in one
flat all-reduce each, before the clip and before the NaN check, so that
every rank takes the same branch and the replicas stay equal.

Tensor parallel (train.tensor_parallelism > 1, parallel/gspmd.py), as the
JAX GSPMD step: each model row runs one data shard with the model's
Megatron-sharded layers; the gradients and the losses are averaged over the
data column, the clip norm sums the sharded gradients' squares over the
model row once, and every rank of a row sees the same loss, so all take the
same NaN branch.

The Gumbel and masking noise comes from a torch.Generator on the device,
seeded by (seed, step, data rank) (the JAX step folds in the axis index),
so a step is reproducible and the ranks of a model row draw the same noise;
at data rank 0 the seed is (seed, step) alone, as at world size 1. It is
not the JAX package's stream (tests inject the same noise into both). The model
and the optimizer are updated in place; `TrainState` carries the step and
the seed. Frozen parameters have requires_grad=False (param_groups.freeze),
so they get no gradient and no share of the clip norm, as the JAX step's
stop_gradient gives them none.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from segclip_tpu_torch.config import Config
from segclip_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD
from segclip_tpu_torch.models.segclip import SegCLIP
from segclip_tpu_torch.ops.device_aug import crop_resize_batch, yuv420_to_rgb
from segclip_tpu_torch.parallel.collectives import mean_across_ranks_, rank_of
from segclip_tpu_torch.parallel.dist import data_size, model_group
from segclip_tpu_torch.train.optimizer import AdaptAdamW, global_norm_clip
from segclip_tpu_torch.train.param_groups import freeze, param_groups
from segclip_tpu_torch.utils.profiling import count, span

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


def normalize_images(batch: Dict[str, torch.Tensor], resolution: int
                     ) -> Dict[str, torch.Tensor]:
    """The batch with "image" as CLIP-normalised float32 (B, resolution,
    resolution, 3) on its device, from whichever transport shipped it:
    "image_y" + "image_cbcr" (yuv420: RGB rebuilt), "image" + "image_window"
    + "image_transposed" (device_aug: the canvas crop-resized to
    `resolution`), or a uint8 "image" (rgb). A float "image" is taken as
    already normalised."""
    batch = dict(batch)
    if "image_y" in batch:
        image = yuv420_to_rgb(batch.pop("image_y"), batch.pop("image_cbcr"))
    elif "image_window" in batch:
        image = crop_resize_batch(batch["image"], batch.pop("image_window"),
                                  batch.pop("image_transposed"), resolution)
    elif batch["image"].dtype == torch.uint8:
        image = batch["image"].float()
    else:
        return batch
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=image.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=image.device)
    count("host_syncs", 2)      # a copy from pageable memory waits for the card
    batch["image"] = (image / 255.0 - mean) / std
    return batch


def step_generator(device: torch.device, seed: int, step: int,
                   rank: int = 0) -> torch.Generator:
    """The step's generator: a function of (seed, step, rank) only. Rank 0
    (and so world size 1) seeds with (seed << 32) | step; another rank with
    63 bits of numpy's SeedSequence of (seed, step, rank)."""
    if not 0 <= seed < 2 ** 31 or not 0 <= step < 2 ** 32 or rank < 0:
        raise ValueError(f"seed {seed}, step {step} or rank {rank} out of range")
    key = (seed << 32) | step
    if rank:
        key = int(np.random.SeedSequence([seed, step, rank]).generate_state(
            1, np.uint64)[0]) >> 1
    return torch.Generator(device=device).manual_seed(key)


def make_train_step(model: SegCLIP, optimizer: AdaptAdamW, cfg: Config
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """step(state, batch, noise=None) → metrics: the loss dict (averaged
    over micro-batches) plus "grad_norm" and "skipped_nan", as 0-d tensors.
    Updates the model, the optimizer and state.step in place. `noise` (the
    keys of models.segclip.NOISE_KEYS, at micro-batch size) replaces the
    draws in every micro-batch; it is for tests. In a process group the
    batch is this rank's data shard, and the metrics are the means over the
    data ranks. Under a torch.profiler the step records the spans
    "train.step" (unit: the state's step) and, inside it, "train.normalize",
    "train.forward", "train.backward", "train.allreduce" (ranks > 1),
    "train.clip", "train.nan_check" and "train.optimizer", the device-side
    ones device-timed on a card; it counts "train.steps" and, at each site
    that waits for the card (the normalisation's two constants, the loss's
    logit-scale cap, the NaN check), "host_syncs" (utils/profiling)."""
    accum = cfg.train.grad_accum_steps
    max_norm = cfg.optim.max_grad_norm
    resolution = cfg.model.image_resolution
    params = [p for p in model.parameters() if p.requires_grad]
    logit_scale = model.clip.logit_scale
    world, rank = data_size(), rank_of()
    row = model_group()

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             noise: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        with span("train.step", unit=state.step):
            with span("train.normalize"):
                batch = normalize_images({k: v for k, v in batch.items() if v is not None},
                                         resolution)
            b = batch["image"].shape[0]
            if accum < 1 or b % accum:
                raise ValueError(f"batch {b} does not split into {accum} micro-batches")
            on_card = batch["image"].device.type == "cuda"
            gen = step_generator(batch["image"].device, state.seed, state.step, rank)
            for p in params:
                p.grad = None
            sums: Dict[str, torch.Tensor] = {}
            for micro in range(accum):
                lo, hi = micro * b // accum, (micro + 1) * b // accum
                mb = {k: v[lo:hi] for k, v in batch.items() if k in BATCH_KEYS}
                with span("train.forward", device=on_card):
                    losses = model(mb["input_ids"], mb["attention_mask"], mb["image"],
                                   mb.get("image_seg"), training=True,
                                   text_class=mb.get("text_class"),
                                   scene_classes=mb.get("scene_classes"),
                                   noise=noise, generator=gen)
                with span("train.backward", device=on_card):
                    losses["loss"].backward()
                for k, v in losses.items():
                    sums[k] = sums.get(k, 0) + v.detach()
            metrics = {k: v / accum for k, v in sums.items()}
            if accum > 1:
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(accum)
            if world > 1:
                with span("train.allreduce", device=on_card):
                    for p in params:
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
                    mean_across_ranks_([p.grad for p in params])
                    keys = sorted(metrics)
                    values = torch.stack([metrics[k].float() for k in keys])
                    mean_across_ranks_([values])
                    metrics = dict(zip(keys, values.unbind()))

            with span("train.clip", device=on_card):
                metrics["grad_norm"] = global_norm_clip(params, max_norm, row)
            with span("train.nan_check"):
                skipped = bool(torch.isnan(metrics["loss"]))
                count("host_syncs")
            if not skipped:
                with span("train.optimizer", device=on_card):
                    optimizer.step()
                    with torch.no_grad():
                        logit_scale.copy_(torch.minimum(
                            logit_scale, torch.full_like(logit_scale, LOGIT_SCALE_MAX)))
            metrics["skipped_nan"] = torch.tensor(float(skipped))
            state.step += 1
        count("train.steps")
        return metrics

    return step
