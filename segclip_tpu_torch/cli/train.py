"""Pretraining CLI (segclip_tpu/cli/train.py, the reference's
main_task_align.py) on one device.

    python -m segclip_tpu_torch.cli.prepare_data shapes --out-dir /data/shapes \
        --train-n 60000 --eval-n 300
    python -m segclip_tpu_torch.cli.train --preset shapes-learnability \
        --data-dir /data/shapes --output-dir output/run

Smoke run on the CPU (no data needed):
    python -m segclip_tpu_torch.cli.train --device cpu --datatype synthetic \
        --batch-size 8 --epochs 1 --opts model.vision_width=64 ...

Runs on the CUDA card (`--device cuda`, the default) and raises when there
is none; `--device cpu` runs on the CPU with the kernels' plain versions.
The data transport is rgb (`data.transfer=rgb` is this CLI's default); the
yuv420 transport, device-side augmentation, tensor and data parallelism,
`train.epochs_per_run`, the `--dist-*` flags and `eval.images_per_device > 1`
are not ported and raise (ROADMAP.md).
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
                      num_workers=args.num_workers, transfer="rgb")
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
    from segclip_tpu_torch.evalseg.inference import evaluate_dataset
    from segclip_tpu_torch.models.segclip import SegCLIP

    if cfg.eval.images_per_device > 1:
        raise ValueError("eval.images_per_device > 1 runs the sharded evaluator, "
                         "which is not ported yet (ROADMAP.md, item 3a)")
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
        return evaluate_dataset(seg, SegEvalDataset(spec, data_root),
                                logger=logger)["mIoU"]

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
                         "e.g. <output-dir>/ckpt_epoch_N/model.pt")
    ap.add_argument("--resume-model", default=None,
                    help="checkpoint directory to resume from")
    ap.add_argument("--do-resume", action="store_true",
                    help="resume from the latest <output-dir>/ckpt_epoch_N")
    ap.add_argument("--num-workers", type=int, default=0,
                    help="decode worker processes (-1 = cpu_count - 1)")
    ap.add_argument("--n-display", type=int, default=50)
    ap.add_argument("--grad-accum-steps", type=int, default=1)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the first epoch")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--output-dir", default="output/pretrain")
    ap.add_argument("--eval-each-epoch", action="store_true")
    ap.add_argument("--eval-data-root", default=None,
                    help="VOC-layout root for per-epoch zero-shot eval")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N, or cpu; the CPU runs the "
                         "kernels' plain versions and is used only when named")
    for flag in ("--dist-coordinator", "--dist-num-processes", "--dist-process-id"):
        ap.add_argument(flag, default=None,
                        help="multi-process training: not ported yet (slice 5)")
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
    if any(v is not None for v in (args.dist_coordinator, args.dist_num_processes,
                                   args.dist_process_id)):
        raise ValueError("the --dist-* flags are not ported: data parallelism is "
                         "slice 5 (ROADMAP.md)")

    cfg = build_config(args)
    logger = get_logger(cfg.train.output_dir)
    logger.info("config: %s", dataclasses.asdict(cfg))

    eval_fn = None
    if args.eval_each_epoch and args.eval_data_root:
        eval_fn = make_eval_fn(cfg, args.eval_data_root, logger)

    from segclip_tpu_torch.train.loop import train
    result = train(cfg, init_model=args.init_model,
                   resume=args.do_resume or bool(args.resume_model),
                   eval_fn=eval_fn, device=args.device, profile_dir=args.profile)
    logger.info("training done: %d epochs, final loss %f",
                result["epochs_run"], result["final_loss"])
    return result


if __name__ == "__main__":
    main()
