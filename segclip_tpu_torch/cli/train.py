"""Pretraining CLI (segclip_tpu/cli/train.py, the reference's
main_task_align.py), on one device or data parallel across processes.

    python -m segclip_tpu_torch.cli.prepare_data shapes --out-dir /data/shapes \
        --train-n 60000 --eval-n 300
    python -m segclip_tpu_torch.cli.train --preset shapes-learnability \
        --data-dir /data/shapes --output-dir output/run

Smoke run on the CPU (no data needed):
    python -m segclip_tpu_torch.cli.train --device cpu --datatype synthetic \
        --batch-size 8 --epochs 1 --opts model.vision_width=64 ...

Data parallel, two processes on one host (each runs this command; the
global batch is split across them; parallel/dist.py picks NCCL with a card
per rank, gloo otherwise):
    python -m segclip_tpu_torch.cli.train --dist-coordinator localhost:29500 \
        --dist-num-processes 2 --dist-process-id {0,1} ...

Tensor parallelism: `--opts train.tensor_parallelism=T` splits the world
into world // T data ranks × T model ranks (parallel/gspmd.py).

Block rematerialisation: `--opts model.remat=true` recomputes the towers'
and the MAE decoders' block activations in the backward instead of keeping
them (models/layers.run_blocks), for batches whose activations do not fit;
the values are those of the run without it. The JAX package's run M recipe
(scripts/runM_batch192.sh), one segment per call:
    python -m segclip_tpu_torch.cli.train --datatype shapes --data-dir D \
        --batch-size 192 --epochs 6 --lr 4e-4 --lower-lr 4e-4 \
        --warmup-proportion 0.1 --use-seglabel --use-vision-mae-recon \
        --eval-each-epoch --eval-data-root D/eval --num-workers 0 \
        --output-dir O --do-resume --opts eval.dataset=shapes \
        model.gumbel_tau=3.0 model.group_balance_weight=1.0 model.remat=true \
        train.keep_best=true train.epochs_per_run=1 train.checkpoint_every=2

Runs on the CUDA card (`--device cuda`, the default) and raises when there
is none; `--device cpu` runs on the CPU with the kernels' plain versions.
It takes the JAX package's training settings, with its defaults: the
yuv420 transport (`data.transfer=rgb` and `data.device_aug=true` select
the other two), and `train.epochs_per_run=N` trains N epochs per run (go on
with `--do-resume`).
"""
from __future__ import annotations

import argparse
import dataclasses
import os

from segclip_tpu_torch.config import (Config, DataConfig, OptimConfig, TrainConfig,
                                      apply_overrides, model_config_for)
from segclip_tpu_torch.utils.logging import get_logger

# Documented one-command recipes (--preset). Values become parser
# DEFAULTS, so any flag the user passes explicitly still wins; the
# preset's `opts` are PREPENDED to --opts, so user overrides win there
# too (apply_overrides is last-wins).
PRESETS = {
    # The from-scratch grounding recipe of the JAX package's schedule/data
    # study: flat lr 4e-4 head AND backbone, 10% warmup, gumbel_tau 3.0 +
    # group_balance 1.0 (the from-scratch anti-collapse aids), B=96
    # both-caption corpus, per-epoch eval with keep_best.
    # (--eval-data-root defaults to <data-dir>/eval under this preset.)
    "shapes-learnability": dict(
        datatype="shapes", batch_size=96, epochs=4, lr=4e-4,
        lower_lr=4e-4, warmup_proportion=0.1, use_seglabel=True,
        use_vision_mae_recon=True, eval_each_epoch=True,
        opts=["eval.dataset=shapes", "model.gumbel_tau=3.0",
              "model.group_balance_weight=1.0", "train.keep_best=true"]),
}


def build_config(args) -> Config:
    model = model_config_for(
        args.clip_arch,
        use_seglabel=args.use_seglabel,
        use_vision_mae_recon=args.use_vision_mae_recon,
        use_text_mae_recon=args.use_text_mae_recon,
        max_words=args.max_words,
        **({} if args.first_stage_layer is None
           else {"first_stage_layer": args.first_stage_layer}))
    optim = OptimConfig(
        lr=args.lr, lower_lr=args.lower_lr,
        warmup_proportion=args.warmup_proportion,
        weight_decay=args.weight_decay,
        freeze_layer_num=args.freeze_layer_num,
        freeze_text_layer_num=args.freeze_text_layer_num)
    data = DataConfig(datatype=args.datatype, batch_size=args.batch_size,
                      max_words=args.max_words, data_dir=args.data_dir,
                      num_workers=args.num_workers)
    train_c = TrainConfig(epochs=args.epochs, seed=args.seed,
                          grad_accum_steps=args.grad_accum_steps,
                          log_every=args.n_display,
                          output_dir=args.output_dir,
                          resume=args.resume_model,
                          eval_each_epoch=args.eval_each_epoch)
    cfg = Config(model=model, optim=optim, data=data, train=train_c)
    return apply_overrides(cfg, args.opts)


def make_eval_fn(cfg: Config, data_root: str, logger):
    """eval_fn(model) → zero-shot mIoU over the SegEvalDataset at
    `data_root`. Under eval.compute_dtype it runs a model of that dtype that
    shares the training model's parameters (the reference evals at fp32
    whatever the training precision, main_seg_zeroshot.py:179)."""
    from segclip_tpu_torch.cli.eval_zeroshot import build_segmenter
    from segclip_tpu_torch.evalseg.datasets import DATASET_SPECS, SegEvalDataset
    from segclip_tpu_torch.evalseg.inference import (evaluate_dataset,
                                                     evaluate_dataset_sharded)
    from segclip_tpu_torch.models.segclip import SegCLIP
    from segclip_tpu_torch.parallel import dist

    spec = DATASET_SPECS[cfg.eval.dataset]
    mcfg = cfg.model
    if cfg.eval.compute_dtype:
        mcfg = dataclasses.replace(mcfg, compute_dtype=cfg.eval.compute_dtype)
    shared = {}

    def eval_fn(model):
        if cfg.eval.compute_dtype:
            if shared.get("of") is not model:
                clone = SegCLIP(mcfg)
                clone.load_state_dict(model.state_dict(), assign=True)
                device = next(model.parameters()).device
                shared.update(of=model, model=clone.to(device).eval())
            model = shared["model"]
        seg = build_segmenter(model, mcfg, spec, template_set=cfg.eval.template_set)
        ds = SegEvalDataset(spec, data_root)
        # the loop calls eval_fn on rank 0 alone, so the sharded evaluator
        # (several images per decode) runs only in a world of one process
        if dist.world_size() == 1 and cfg.eval.images_per_device > 1:
            return evaluate_dataset_sharded(
                seg, ds, logger=logger,
                images_per_device=cfg.eval.images_per_device)["mIoU"]
        return evaluate_dataset(seg, ds, logger=logger)["mIoU"]

    return eval_fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--datatype", default="synthetic",
                    help='comma-joined dataset names, e.g. "cc,coco," '
                         'or "synthetic"')
    ap.add_argument("--data-dir", default="")
    ap.add_argument("--batch-size", type=int, default=768,
                    help="GLOBAL batch size")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--lr", type=float, default=4e-3)
    ap.add_argument("--lower-lr", type=float, default=4e-6)
    ap.add_argument("--warmup-proportion", type=float, default=0.15)
    ap.add_argument("--weight-decay", type=float, default=0.05)
    ap.add_argument("--max-words", type=int, default=32)
    ap.add_argument("--clip-arch", default="ViT-B/16",
                    choices=["ViT-B/16", "ViT-B/32", "ViT-L/14"],
                    help="CLIP backbone preset (the reference's "
                         "pretrained_clip_name, modeling.py:38-41)")
    ap.add_argument("--first-stage-layer", type=int, default=None,
                    help="override the preset's two-stage split point")
    ap.add_argument("--freeze-layer-num", type=int, default=0)
    ap.add_argument("--freeze-text-layer-num", type=int, default=0)
    ap.add_argument("--use-seglabel", action="store_true")
    ap.add_argument("--use-vision-mae-recon", action="store_true")
    ap.add_argument("--use-text-mae-recon", action="store_true")
    ap.add_argument("--init-model", default=None,
                    help="reference-layout torch state dict (.bin/.pt/.pth), "
                         "e.g. <output-dir>/ckpt_epoch_N/model.pt, or an Orbax "
                         "directory (the JAX package's params or ckpt_epoch_N)")
    ap.add_argument("--resume-model", default=None,
                    help="checkpoint directory to resume from (the port's or an "
                         "Orbax one)")
    ap.add_argument("--do-resume", action="store_true",
                    help="resume from the latest <output-dir>/ckpt_epoch_N")
    ap.add_argument("--num-workers", type=int, default=0,
                    help="decode worker processes (-1 = cpu_count - 1)")
    ap.add_argument("--n-display", type=int, default=50)
    ap.add_argument("--grad-accum-steps", type=int, default=1)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the first epoch; it carries "
                         "the program's spans (train.step and its phases)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--output-dir", default="output/pretrain")
    ap.add_argument("--eval-each-epoch", action="store_true")
    ap.add_argument("--eval-data-root", default=None,
                    help="VOC-layout root for per-epoch zero-shot eval")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N, or cpu; the CPU runs the "
                         "kernels' plain versions and is used only when named")
    ap.add_argument("--dist-coordinator", default=None, metavar="HOST:PORT",
                    help="data-parallel rendezvous: HOST:PORT of rank 0, or an "
                         "init URL (tcp://…, file://…); also read from "
                         "SEGCLIP_DIST_COORDINATOR, or torchrun's variables "
                         "under SEGCLIP_DIST=1")
    ap.add_argument("--dist-num-processes", type=int, default=None)
    ap.add_argument("--dist-process-id", type=int, default=None)
    ap.add_argument("--opts", nargs="*", default=[],
                    help="config overrides, e.g. model.vision_width=256")
    ap.add_argument("--preset", default=None, choices=sorted(PRESETS),
                    help="named recipe applied as parser defaults "
                         "(explicit flags and --opts still win)")

    # two-pass parse: the preset sets DEFAULTS, so explicit flags override
    pre, _ = ap.parse_known_args(argv)
    preset_opts: list = []
    if pre.preset:
        preset = dict(PRESETS[pre.preset])
        preset_opts = list(preset.pop("opts", []))
        ap.set_defaults(**preset)
    args = ap.parse_args(argv)
    args.opts = preset_opts + args.opts
    if (args.preset and args.eval_data_root is None and args.data_dir
            and args.eval_each_epoch):
        args.eval_data_root = os.path.join(args.data_dir, "eval")

    from segclip_tpu_torch.parallel import dist
    from segclip_tpu_torch.train.loop import train
    cfg = build_config(args)
    device = dist.init_distributed(args.device, args.dist_coordinator,
                                   args.dist_num_processes, args.dist_process_id)
    try:
        # log.txt is rank 0's; every rank logs to its own stderr
        logger = get_logger(cfg.train.output_dir if dist.rank() == 0 else None)
        logger.info("config: %s", dataclasses.asdict(cfg))
        eval_fn = None
        if args.eval_each_epoch and args.eval_data_root:
            eval_fn = make_eval_fn(cfg, args.eval_data_root, logger)
        result = train(cfg, init_model=args.init_model,
                       resume=args.do_resume or bool(args.resume_model),
                       eval_fn=eval_fn, device=device, profile_dir=args.profile)
        logger.info("training done: %d epochs, final loss %f",
                    result["epochs_run"], result["final_loss"])
    finally:
        dist.shutdown()
    return result


if __name__ == "__main__":
    main()
