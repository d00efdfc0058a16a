"""The training loop (segclip_tpu/train/loop.py) on one device: epochs of
the training step over the record pipeline, with logging, checkpoints,
resume, and the per-epoch zero-shot eval with keep_best.

Cadence mirrors main_task_align.py:292-359 + 455-495: per-`log_every` step
LR/loss/time logging, per-epoch checkpoint, optional in-training mIoU.

Not ported, and refused with a message rather than run otherwise: tensor
parallelism, more than one data-parallel device (slice 5), and
`train.epochs_per_run` (ROADMAP.md). `data.packed_transfer` has no meaning
here (each field is copied through pinned memory) and is ignored.
"""
from __future__ import annotations

import functools
import json
import math
import os
import time
from typing import Callable, Optional

from segclip_tpu_torch.checkpoint.io import (auto_resume_path, restore_checkpoint,
                                             save_checkpoint)
from segclip_tpu_torch.config import Config
from segclip_tpu_torch.data.pipeline import BatchLoader, ShardedEpochSampler, build_dataset
from segclip_tpu_torch.models.segclip import init_segclip
from segclip_tpu_torch.parallel.prefetch import prefetch_to_device
from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step
from segclip_tpu_torch.utils.device import resolve_device
from segclip_tpu_torch.utils.logging import MetricWriter, get_logger
from segclip_tpu_torch.utils.profiling import trace_if


def check_supported(cfg: Config) -> None:
    """Raise for the settings whose paths the port does not have."""
    t = cfg.train
    if t.tensor_parallelism != 1:
        raise ValueError(f"train.tensor_parallelism={t.tensor_parallelism} is not "
                         f"ported (ROADMAP.md, 'do not port')")
    if t.data_parallelism not in (1, -1):
        raise ValueError(f"train.data_parallelism={t.data_parallelism}: the port "
                         f"trains on one device; data parallelism is slice 5 "
                         f"(ROADMAP.md)")
    if t.epochs_per_run > 0:
        raise ValueError("train.epochs_per_run is not ported (ROADMAP.md, 'do not "
                         "port'): resume with --do-resume instead")


def train(cfg: Config, init_model: Optional[str] = None, resume: bool = False,
          eval_fn: Optional[Callable] = None, device=None,
          profile_dir: Optional[str] = None) -> dict:
    """Returns {'epochs_run', 'final_loss', 'checkpoints', 'state', 'model',
    'optimizer'}.

    eval_fn(model) → mIoU float, called per epoch when
    cfg.train.eval_each_epoch (cli/train.py wires the zero-shot evaluator
    in). `device`: "cuda" (None), "cuda:N" or "cpu"; the CPU only when
    named. `profile_dir`: a torch.profiler trace of the first epoch run."""
    check_supported(cfg)
    device = resolve_device(device)
    logger = get_logger(cfg.train.output_dir)
    metrics_writer = MetricWriter(cfg.train.output_dir)
    if cfg.data.packed_transfer:
        logger.info("data.packed_transfer is ignored: the port copies each batch "
                    "field through pinned memory (ROADMAP.md, 'do not port')")

    # The pipeline ships uint8 images; the train step normalizes on device.
    factory = functools.partial(
        build_dataset, cfg.data, use_seg=cfg.model.use_seglabel, normalize=False,
        vocab_size=cfg.model.vocab_size, image_size=cfg.model.image_resolution,
        patch_size=cfg.model.vision_patch_size,
        emit_class_ids=cfg.model.infonce_mask != "none")
    dataset = factory()
    sampler = ShardedEpochSampler(len(dataset), cfg.data.batch_size,
                                  seed=cfg.train.seed)
    num_workers = cfg.data.num_workers
    if num_workers < 0:
        num_workers = max(1, (os.cpu_count() or 1) - 1)
    loader = BatchLoader(dataset, sampler, seed=cfg.train.seed,
                         prefetch=cfg.data.prefetch, num_workers=num_workers,
                         dataset_factory=factory)
    try:
        steps_per_epoch = sampler.steps
        if steps_per_epoch == 0:
            raise ValueError(
                f"dataset of {len(dataset)} samples yields zero steps at global "
                f"batch {cfg.data.batch_size} — reduce the batch size")
        t_total = steps_per_epoch * cfg.train.epochs
        logger.info("dataset=%s len=%d steps/epoch=%d t_total=%d device=%s",
                    cfg.data.datatype, len(dataset), steps_per_epoch, t_total, device)

        if init_model:
            from segclip_tpu_torch.cli.common import load_model
            model, _ = load_model(init_model, cfg.model, device)
        else:
            model = init_segclip(cfg.model, seed=cfg.train.seed, device=device)
        n_params = sum(p.numel() for p in model.parameters())
        logger.info("model parameters: %.1fM", n_params / 1e6)
        optimizer = create_optimizer(model, cfg, t_total)
        step_fn = make_train_step(model, optimizer, cfg)
        state = TrainState(step=0, seed=cfg.train.seed)

        start_epoch = 0
        if resume:
            path = cfg.train.resume or auto_resume_path(cfg.train.output_dir)
            if path:
                state, last_epoch = restore_checkpoint(path, model, optimizer, state)
                start_epoch = last_epoch + 1
                logger.info("resumed from %s → epoch %d", path, start_epoch)

        ckpts: list = []
        final_loss = _run_epochs(cfg, range(start_epoch, cfg.train.epochs), loader,
                                 step_fn, state, model, optimizer, device,
                                 steps_per_epoch, eval_fn, logger, metrics_writer,
                                 ckpts, profile_dir)
    finally:
        # a step failure or KeyboardInterrupt must not leak decode workers
        loader.close()
    return {"epochs_run": max(0, cfg.train.epochs - start_epoch),
            "final_loss": final_loss, "checkpoints": ckpts,
            "state": state, "model": model, "optimizer": optimizer}


def _read_best(output_dir: str) -> dict:
    """{'miou': float, 'epoch': int} from <output_dir>/best.json, or the
    sentinel — keep_best's running maximum persists across resumes."""
    path = os.path.join(output_dir, "best.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"miou": -1.0, "epoch": -1}


def _run_epochs(cfg, epochs, loader, step_fn, state, model, optimizer, device,
                steps_per_epoch, eval_fn, logger, metrics_writer, ckpts,
                profile_dir) -> float:
    """Train `epochs` (a range), appending each checkpoint's path to
    `ckpts`; returns the last step's loss."""
    final_loss = float("nan")
    keep_best = cfg.train.keep_best
    if keep_best and not (eval_fn is not None and cfg.train.eval_each_epoch):
        logger.warning("train.keep_best needs eval_each_epoch + an eval "
                       "dataset — ignoring it")
        keep_best = False
    best = float(_read_best(cfg.train.output_dir)["miou"]) if keep_best else -1.0
    for epoch in epochs:
        t_start = time.time()
        window_start = time.time()
        n_steps = 0
        with trace_if(profile_dir, enabled=profile_dir is not None and epoch == epochs[0]):
            for batch in prefetch_to_device(loader.epoch(epoch), device,
                                            depth=cfg.data.device_prefetch):
                metrics = step_fn(state, batch)
                if state.step % cfg.train.log_every == 0:
                    loss = float(metrics["loss"])
                    lr = cfg.optim.lr * optimizer.schedule_factor(optimizer.step_count)
                    dt = (time.time() - window_start) / cfg.train.log_every
                    window_start = time.time()
                    logger.info(
                        "Epoch %d/%d Step %d/%d Lr %.9f Loss %f Time/step %.3f",
                        epoch + 1, cfg.train.epochs, n_steps + 1,
                        steps_per_epoch, lr, loss, dt)
                    metrics_writer.write(state.step, epoch=epoch, lr=lr,
                                         **{k: float(v) for k, v in metrics.items()})
                n_steps += 1

        final_loss = float(metrics["loss"])
        logger.info("Epoch %d done in %.1fs, last loss %f",
                    epoch + 1, time.time() - t_start, final_loss)

        # every checkpoint_every epochs, and always after the last one
        if (epoch + 1) % cfg.train.checkpoint_every == 0 or epoch == epochs[-1]:
            path = save_checkpoint(cfg.train.output_dir, epoch, model, optimizer, state)
            ckpts.append(path)
            logger.info("checkpoint saved to %s", path)

        if eval_fn is not None and cfg.train.eval_each_epoch:
            miou = float("nan")
            try:
                miou = float(eval_fn(model))
            except Exception as e:               # eval must not kill training
                logger.warning("per-epoch eval failed: %s: %s", type(e).__name__, e,
                               exc_info=True)
            if not math.isnan(miou):
                logger.info("Epoch %d zero-shot mIoU: %.2f", epoch + 1, miou)
                metrics_writer.write(state.step, epoch=epoch, miou=miou)
                if keep_best and miou > best:
                    best = miou
                    path = save_checkpoint(cfg.train.output_dir, epoch, model,
                                           optimizer, state, name="ckpt_best")
                    with open(os.path.join(cfg.train.output_dir, "best.json"), "w") as f:
                        json.dump({"miou": best, "epoch": epoch}, f)
                    logger.info("new best mIoU %.2f → %s", best, path)
    return final_loss
