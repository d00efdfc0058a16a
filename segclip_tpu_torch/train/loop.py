"""The training loop (segclip_tpu/train/loop.py): epochs of the training
step over the record pipeline, with logging, checkpoints, resume, and the
per-epoch zero-shot eval with keep_best, on one device or data parallel
across the ranks of a process group (parallel/dist.py).

Cadence mirrors main_task_align.py:292-359 + 455-495: per-`log_every` step
LR/loss/time logging, per-epoch checkpoint, optional in-training mIoU.

Across ranks, as the JAX loop across hosts: each rank loads its shard of
every global batch (`ShardedEpochSampler(shard=rank, num_shards=world)`);
log.txt, metrics.jsonl and best.json are written by rank 0 only; rank 0
saves each checkpoint (torch.save is not a collective, unlike Orbax's save)
and the others wait at a barrier; rank 0 runs the per-epoch eval and
broadcasts its mIoU, and keep_best's running best, so that every rank takes
the same branch. A warm-up collective runs before the first step.

`train.epochs_per_run` = N > 0 trains at most N epochs per run and stops
(a segment); `--do-resume` goes on from the last checkpoint, the schedule
spanning all `train.epochs`, and best.json carries keep_best's running
best across segments. The checkpoint resumed from may be the port's own
(`model.pt`, checkpoint/io.py) or an Orbax directory (`_METADATA`, the JAX
package's, checkpoint/orbax_io.py); the loop writes its own kind.

`train.tensor_parallelism` = T > 1 (segclip_tpu/train/loop.py:103-125,
270-281): the world is split into world // T data indices × T model ranks
(parallel/dist.init_grid), and after the init, `--init-model` or resume the
model is sharded over its model row (parallel/gspmd.shard_model_). Each
rank loads its data index's shard of every batch, so the ranks of a row
step on the same rows. Before each checkpoint every rank gathers the full
state and rank 0 writes it in the tp = 1 layout, so a checkpoint resumes
at any tensor parallelism; before the per-epoch eval they gather the model
and rank 0 evaluates a full copy of it.

Refused with a message rather than run otherwise: a tensor parallelism
that does not divide the world size, and a `train.data_parallelism` other
than -1 or world // tensor parallelism. `data.packed_transfer` has no
meaning here (each field is copied through pinned memory) and is ignored,
as are `model.attention_impl` and `model.grouping_impl` (one log line each
when set; an attention_impl the JAX package refuses raises).
"""
from __future__ import annotations

import functools
import json
import math
import os
import time
from typing import Callable, Optional

from segclip_tpu_torch.checkpoint import io as ckpt_io
from segclip_tpu_torch.checkpoint import orbax_io
from segclip_tpu_torch.config import Config
from segclip_tpu_torch.data.pipeline import BatchLoader, ShardedEpochSampler, build_dataset
from segclip_tpu_torch.models.segclip import SegCLIP, check_kernel_fields, init_segclip
from segclip_tpu_torch.parallel import dist, gspmd
from segclip_tpu_torch.parallel.prefetch import prefetch_to_device
from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step
from segclip_tpu_torch.utils.device import resolve_device
from segclip_tpu_torch.utils.logging import MetricWriter, get_logger
from segclip_tpu_torch.utils.profiling import count, trace_if


def check_supported(cfg: Config) -> None:
    """Raise for the settings whose paths the port does not have."""
    t = cfg.train
    world, tp = dist.world_size(), t.tensor_parallelism
    if tp < 1 or world % tp:
        raise ValueError(f"train.tensor_parallelism={tp} must divide the world size "
                         f"({world})")
    if t.data_parallelism not in (-1, world // tp):
        raise ValueError(f"train.data_parallelism={t.data_parallelism} must be -1 or "
                         f"the world size, {world}, over train.tensor_parallelism={tp}: "
                         f"start that many processes with the --dist-* flags (README.md)")


def train(cfg: Config, init_model: Optional[str] = None, resume: bool = False,
          eval_fn: Optional[Callable] = None, device=None,
          profile_dir: Optional[str] = None) -> dict:
    """Returns {'epochs_run', 'final_loss', 'checkpoints', 'state', 'model',
    'optimizer'}.

    eval_fn(model) → mIoU float, called per epoch when
    cfg.train.eval_each_epoch (cli/train.py wires the zero-shot evaluator
    in). `device`: "cuda" (None), "cuda:N" or "cpu"; the CPU only when
    named; in a process group, this rank's device. `profile_dir`: a
    torch.profiler trace of rank 0's first epoch run."""
    check_supported(cfg)
    device = resolve_device(device)
    rank, world = dist.rank(), dist.world_size()
    tp = cfg.train.tensor_parallelism
    dist.init_grid(tp)
    logger = get_logger(cfg.train.output_dir if rank == 0 else None)
    metrics_writer = MetricWriter(cfg.train.output_dir) if rank == 0 else None
    if cfg.data.packed_transfer:
        logger.info("data.packed_transfer is ignored: the port copies each batch "
                    "field through pinned memory (ROADMAP.md, 'do not port')")
    check_kernel_fields(cfg.model, logger.info)

    # The pipeline ships uint8 images; the train step normalizes on device.
    factory = functools.partial(
        build_dataset, cfg.data, use_seg=cfg.model.use_seglabel, normalize=False,
        vocab_size=cfg.model.vocab_size, image_size=cfg.model.image_resolution,
        patch_size=cfg.model.vision_patch_size,
        emit_class_ids=cfg.model.infonce_mask != "none")
    dataset = factory()
    # the ranks of a model row load the same shard
    sampler = ShardedEpochSampler(len(dataset), cfg.data.batch_size,
                                  shard=dist.data_rank(), num_shards=dist.data_size(),
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
        logger.info("dataset=%s len=%d steps/epoch=%d t_total=%d device=%s rank=%d/%d",
                    cfg.data.datatype, len(dataset), steps_per_epoch, t_total, device,
                    rank, world)

        if init_model:
            from segclip_tpu_torch.cli.common import load_model
            model, _ = load_model(init_model, cfg.model, device)
        else:
            model = init_segclip(cfg.model, seed=cfg.train.seed, device=device)
        n_params = sum(p.numel() for p in model.parameters())
        logger.info("model parameters: %.1fM", n_params / 1e6)
        shard = None
        if tp > 1:
            gspmd.shard_model_(model)
            shard = functools.partial(gspmd.shard_state_dict, model)
            logger.info("grid: dp %d × tp %d (backend %s), %.1fM parameters on this rank",
                        dist.data_size(), tp, dist.backend(),
                        sum(p.numel() for p in model.parameters()) / 1e6)
        optimizer = create_optimizer(model, cfg, t_total)
        step_fn = make_train_step(model, optimizer, cfg)
        state = TrainState(step=0, seed=cfg.train.seed)

        start_epoch = 0
        if resume:
            path = cfg.train.resume or orbax_io.auto_resume_path(cfg.train.output_dir)
            if path:
                # by what the directory holds: model.pt is the port's own
                # checkpoint, _METADATA an Orbax one (the JAX package's)
                restore = (orbax_io.restore_checkpoint if orbax_io.is_orbax_dir(path)
                           else ckpt_io.restore_checkpoint)
                state, last_epoch = restore(path, model, optimizer, state, shard=shard)
                start_epoch = last_epoch + 1
                logger.info("resumed from %s → epoch %d", path, start_epoch)

        end_epoch = cfg.train.epochs
        if cfg.train.epochs_per_run > 0:
            end_epoch = min(end_epoch, start_epoch + cfg.train.epochs_per_run)

        dist.warmup()
        ckpts: list = []
        final_loss = _run_epochs(cfg, range(start_epoch, end_epoch), loader,
                                 step_fn, state, model, optimizer, device,
                                 steps_per_epoch, eval_fn, logger, metrics_writer,
                                 ckpts, profile_dir)
    finally:
        # a step failure or KeyboardInterrupt must not leak decode workers
        loader.close()
    return {"epochs_run": max(0, end_epoch - start_epoch),
            "final_loss": final_loss, "checkpoints": ckpts,
            "state": state, "model": model, "optimizer": optimizer}


def _read_best(output_dir: str) -> dict:
    """{'miou': float, 'epoch': int} from <output_dir>/best.json, or the
    sentinel — keep_best's running maximum persists across resumes and
    epochs_per_run segments."""
    path = os.path.join(output_dir, "best.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"miou": -1.0, "epoch": -1}


def _run_epochs(cfg, epochs, loader, step_fn, state, model, optimizer, device,
                steps_per_epoch, eval_fn, logger, metrics_writer, ckpts,
                profile_dir) -> float:
    """Train `epochs` (a range), appending each checkpoint's path to
    `ckpts` (on rank 0); returns the last step's loss, the mean over the
    ranks."""
    final_loss = float("nan")
    lead = dist.rank() == 0
    keep_best = cfg.train.keep_best
    if keep_best and not (eval_fn is not None and cfg.train.eval_each_epoch):
        logger.warning("train.keep_best needs eval_each_epoch + an eval "
                       "dataset — ignoring it")
        keep_best = False
    best = -1.0
    if keep_best:
        # rank 0 owns best.json; every rank takes the same save-or-not branch
        best = dist.broadcast_float(
            float(_read_best(cfg.train.output_dir)["miou"]) if lead else -1.0)

    sharded = cfg.train.tensor_parallelism > 1

    def save(epoch, name=None):
        path = None
        # a collective under tensor parallelism: every rank gathers
        full = gspmd.gather_state_dict(model, optimizer.state_dict()) if sharded else None
        if lead:
            path = ckpt_io.save_checkpoint(cfg.train.output_dir, epoch, model, optimizer,
                                           state, name=name, state_dicts=full)
        dist.barrier()
        return path

    full_copy = []

    def eval_model():
        """The model to evaluate on rank 0: under tensor parallelism one full
        copy, loaded each epoch from the gathered state (every rank
        gathers), else the model."""
        if not sharded:
            return model
        full, _ = gspmd.gather_state_dict(model)
        if not lead:
            return None
        if not full_copy:
            full_copy.append(SegCLIP(cfg.model).to(device).eval())
        full_copy[0].load_state_dict(full)
        return full_copy[0]

    for epoch in epochs:
        t_start = time.time()
        window_start = time.time()
        n_steps = 0
        with trace_if(profile_dir, enabled=(profile_dir is not None and lead
                                            and epoch == epochs[0])):
            for batch in prefetch_to_device(loader.epoch(epoch), device,
                                            depth=cfg.data.device_prefetch):
                metrics = step_fn(state, batch)
                if lead and state.step % cfg.train.log_every == 0:
                    loss = float(metrics["loss"])
                    count("host_syncs", 1 + len(metrics))   # the loss, then each logged metric
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
        count("host_syncs")
        logger.info("Epoch %d done in %.1fs, last loss %f",
                    epoch + 1, time.time() - t_start, final_loss)

        # every checkpoint_every epochs, and always after the last one of
        # this run (the schedule's end, or a segment's), so a resume has one
        if (epoch + 1) % cfg.train.checkpoint_every == 0 or epoch == epochs[-1]:
            path = save(epoch)
            if lead:
                ckpts.append(path)
                logger.info("checkpoint saved to %s", path)

        if eval_fn is not None and cfg.train.eval_each_epoch:
            # rank 0 evaluates; the others wait at the broadcast
            miou = float("nan")
            evaluated = eval_model()
            if lead:
                try:
                    miou = float(eval_fn(evaluated))
                except Exception as e:           # eval must not kill training
                    logger.warning("per-epoch eval failed: %s: %s", type(e).__name__, e,
                                   exc_info=True)
            miou = dist.broadcast_float(miou)
            if not math.isnan(miou):
                logger.info("Epoch %d zero-shot mIoU: %.2f", epoch + 1, miou)
                if lead:
                    metrics_writer.write(state.step, epoch=epoch, miou=miou)
                if keep_best and miou > best:
                    best = miou
                    path = save(epoch, name="ckpt_best")
                    if lead:
                        with open(os.path.join(cfg.train.output_dir, "best.json"),
                                  "w") as f:
                            json.dump({"miou": best, "epoch": epoch}, f)
                        logger.info("new best mIoU %.2f → %s", best, path)
    return final_loss
