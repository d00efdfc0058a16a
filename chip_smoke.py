"""Drive the PyTorch port's zero-shot segmentation path, its training step,
pretraining through the CLI on its three input transports, checkpoint
ingest, the demo, the sharded evaluator, data- and tensor-parallel
training, the studies that load a model, the device-side transforms,
block rematerialisation with the JAX package's memory-bound training
configurations, ViT-B/32 and the JAX package's 12-step training trajectory
on one CUDA card (an H100), and check them.

    python3 chip_smoke.py

Builds the port's CUDA kernels from segclip_tpu_torch/csrc, then:

  1. kernels vs plain: each kernel against its plain PyTorch version on the
     card, at every shape of both paths (phase 12's configurations, phase
     13's ViT-B/32 eval and training shapes and phase 14's tiny ones
     included), in float32 (TF32 off) and bfloat16,
     with the tolerance stated beside each, and the time per call by CUDA
     events: the attention forward (eval shapes, and training shapes with P
     saved), the attention backward, the eval grouping and the Gumbel
     (training) grouping at each of their shapes, each grouping call run
     twice and required to give the same bits; at every bf16 shape the
     one-pass, the cluster or the long forward takes, the two-pass forward
     too, and at every bf16 shape the one-pass, the cluster or the long
     backward takes, the two-pass backward too, each on the same inputs and
     held to the same rules; every float32 forward, of any length, on the TF32x3
     kernel (fp32-accurate split products on TF32 wgmma), and at
     F32_TIMED's shapes PR 1's SIMT two-pass kernel beside it; the rows past
     1024 keys (the long kernel at bf16, the TF32x3 kernel at float32) at
     phase 2's 1x1176 and cross 1x8x1184 and the 224x2048 image's 1x1792
     and cross 1x8x1800, with P saved at 1x1176, and with bias2d and biasb
     at 2x1100, and the forward kernels' branch-free division against IEEE
     `/` over every significand of l in [1, 2) at 2^0..2^13, and from
     1x1176's P the long backwards (both dtypes) against the plain version,
     the same bits twice and timed beside the two-pass pairs; every float32
     backward of up to 256 keys on the TF32x3 backward (a cluster per
     (batch, head) over 64-key slabs), longer ones (phase 12's float32
     ViT-L/14 cross rows, the float32 448 px step's 784 and 792) on the
     TF32x3 long backward, and bf16 ones past 1024 keys (the 672 px step's
     1764 and 1772) on the long backward, each long backward the same bits
     over two calls, and at F32_TIMED's training shapes the SIMT pair
     beside it; each call's route read
     from the route counters; the host time per forward and per backward
     call (enqueue only) of each route; and the repaired fault: on
     CUDA, the outputs of `attention` and `group_assign` require grad when
     their inputs do;
  2. the eval slice: ViT-B/16 at the default ModelConfig (bfloat16) from a
     seeded random init; a 20-class text bank; five requests through
     ZeroShotSegmenter (224×224 whole, 224×448 slide, a 300×500 image in
     slide mode answered at its original size, 224×336 whole, whose 294
     patches take the cluster kernel, 448×672 whole and 224×2048 whole,
     whose 1176 and 1792 patches take the long kernel, one group map); the
     kernels' launch counters must show every attention and grouping call
     of the path went through the kernels;
  3. the eval path against its plain self: a 224×224 and a 448×672 whole
     request at float32 on the card and on the CPU (where the wrappers take
     the plain versions), the 448×672 one's rows past 1024 keys on the
     TF32x3 kernel;
  4. the training slice: ViT-B/16 at the default ModelConfig (bfloat16,
     vision MAE and seglabel on, text MAE off) from `init_segclip(seed=0)`,
     B = 96 synthetic pairs from numpy seed 0, 1 + 5 steps of
     `make_train_step`: finite losses, frozen parameters bit-identical,
     trainable ones moved, per-step launch counters equal to the path's
     count (attention forward and backward, Gumbel grouping, and the MAE
     decoder's plain-route attention), every forward and every backward on
     its one-pass kernel, warm step time and peak memory;
  5. the training step against its plain self: one float32 step at full
     width with B = 2 and injected noise, on the card and on the CPU;
  6. pretraining through the CLI from SGR records: `prepare_data shapes`
     (96 scenes, two captions each, native Felzenszwalb superpixels, a
     4-image VOC-layout eval split), then run A, `cli.train --preset
     shapes-learnability --epochs 2 --num-workers 4` at ViT-B/16 width
     (B = 96, 2 steps per epoch, per-epoch eval on the card, keep_best) on
     the CLI's default transport, yuv420: finite losses, checkpoints, the
     launch counters of every step and every eval request; a resume from
     run A's first checkpoint must train epoch 1 only and reproduce run A's
     last loss and model.pt; run C, the same preset with
     `data.device_aug=true train.epochs_per_run=1`, run twice (the second
     with --do-resume), must train epoch 0, then epoch 1, write both
     checkpoints and best.json, with the path's launches per step; the
     loop's time per step of each run beside phase 4's, and the loader's
     rate alone in each transport (rgb, yuv420, device_aug);
  7. checkpoint ingest and the demo: the seeded ViT-B/16 written as
     OpenAI's TorchScript ViT-B-16.pt (fp16, resblocks, metadata tensors)
     and as a segclip.bin, each read back through cli.common.load_model
     (ModelConfig() inferred, every tensor bit for bit after the fp32 cast,
     exactly the semantic learner, MAE path and MAE decoder tensors missing
     from the CLIP file), then cli.demo on the card in single-image and
     dataset mode with every --vis mode over phase 6's eval split: the files
     written and the launches per request;
  8. the sharded evaluator: 8 images of mixed sizes at 1 and 4 images per
     decode call against one at a time, float32 (≥ 99.9 % of pixels equal,
     mIoU within 0.01) and bf16 (flip share and img/s reported); the eval
     CLI in one process and, in phase 9's spawned ranks, in two;
  9. data and tensor parallel, two spawned ranks (NCCL with a card each
     where there are two cards, else gloo sharing the card): one float32
     step of 2 × 4 against 1 × 8 with injected noise (loss within 1e-4,
     hard assignments equal away from near ties), 1 + 5 bf16 steps of 2 ×
     48 (launches per rank per step, warm step time beside phase 4's 1 ×
     96); then the same ranks as one dp1 × tp2 grid (parallel/gspmd.py):
     the float32 step at 1 × 8 on each rank against 1 × 8 (the same
     tolerances, and every gathered parameter after the step within 1e-4),
     1 + 5 bf16 steps at 48 on each rank (launches, the bytes all-reduced
     over the model row per step, peak memory); then `cli.train --dist-*`
     for one epoch of phase 6's corpus on the rgb transport (`--opts
     data.transfer=rgb`), once at tensor parallelism 1 and once at 2, rank
     0's model.pt of each evaluated in one process (the tp = 2 one in the
     tp = 1 layout);
 10. the studies (segclip_tpu_torch/studies), each a subprocess on the card
     on phase 6's best checkpoint and a holdout corpus (16 eval images, 48
     pair images): classprobe at a batch of 16, the margin probe on 8
     images, the holdout study with both banks, the ipd study at 4 images
     per call in float32 (≥ 99.9 % of pixels equal, mIoU within 0.01) and
     bf16; each report with its script's keys and finite numbers, and each
     study's launches equal to its path's (attention forward and eval
     grouping only); and `studies.host_stage_bench` on phase 6's corpus
     (the host's ms per sample of each pipeline stage and transport);
 11. the transports: host→device bytes and copy time of phase 6's batch
     in each transport; on phase 6's B = 96 batches, `yuv420_to_rgb` with
     the step's normalisation (card vs CPU within 1e-3 on the [0, 255]
     scale) and `crop_resize_batch` over wide and transposed samples (card
     vs CPU within one uint8 level, at most a 1e-3 share of values apart),
     each with its device ms per call by CUDA events beside its bound;
 12. remat (ModelConfig.remat) and the large configurations, bf16 from
     seeded inits on phase 4's synthetic batch at each size: ViT-B/16 at
     B = 96 with and without remat (losses and the first step's gradients
     before the optimizer within phase 6's resume tolerances, bit for bit
     expected and printed; warm step time, peak memory, launches per step
     equal to the path's count with the recompute), and the float32 B = 2
     step with remat on the card against phase 5's CPU step; B = 256 both
     ways and B = 512 with remat (under the card's memory; B = 512 without
     remat estimated, not run); ViT-L/14 at B = 32 both ways and ViT-B/16
     at 448 px, B = 24 (finite losses that fall); one float32 ViT-L/14 step
     at B = 2, whose cross blocks (264 keys) take the TF32x3 long backward;
     a cold and a warm step of ViT-B/16 at 448 px in float32, B = 2 (784
     and 792 keys: the TF32x3 long backward), and at 672 px in bf16, B = 4
     (1764 and 1772 keys: the long forward and backward), finite losses;
     each step's kernel shapes among phase 1's; run M's recipe (scripts/runM_batch192.sh, B = 192,
     remat) through cli.train in two --do-resume calls of one epoch on a
     192-scene corpus (launches, model.pt in the tp = 1 layout evaluating
     to the logged mIoU); and, in phase 9's ranks, the dp1 × tp2 bf16 steps
     again with remat (losses against those without, bytes all-reduced per
     step);
 13. ViT-B/32 (CLIP_ARCH_PRESETS, patch 32: 7 × 7 patches at 224 px), bf16
     from a seeded init: phase 2's requests (224×224 whole, 224×448 slide,
     a group map) with each request's launches equal to the path's count
     and its attention shapes among phase 1's; phase 5's float32 B = 2
     step on the card against the CPU; 1 + 5 steps of `make_train_step` at
     B = 96 (finite losses, launches per step, the first step's kernel
     shapes among phase 1's, warm step time, img/s and own peak memory
     beside phase 4's ViT-B/16); `cli.train --preset shapes-learnability
     --clip-arch ViT-B/32 --epochs 1` on phase 6's corpus and default
     transport (yuv420) with per-epoch eval on the card (launches per step,
     per eval request and outside them; model.pt of ViT-B/32's shapes
     evaluating to the logged mIoU);
 14. the drift trajectory: tests/test_training_drift.py's 12 float32 steps
     (its tiny config, batch and schedule) from tests/fixtures/torch_drift.npz
     (JAX's init, batch and each step's Gumbel and masking draws, recorded
     by tests/test_torch_drift.py), TF32 off, every step's loss within rtol
     5e-4 of JAX's (the JAX test's own bound; the worst gap per step
     printed), launches per step equal to the path's count;
every earlier phase runs as before and holds every kernel against its
plain version as before;
then device time from torch.profiler: each kernel, its plain version and,
for attention, one PyTorch call computing the same function
(`scaled_dot_product_attention`, its backend read from the profiler's
kernel names), at the phase-1 shapes, each beside its bound
(segclip_tpu_torch/ops/kernels/bounds.py) and, where a one-pass or a
cluster kernel (forward or backward) ran, the two-pass kernel's time on the
same inputs, which must be the longer (the two measured in turns, three
rounds each, medians compared), and at F32_TIMED's float32 shapes the SIMT
kernels' beside the TF32x3 kernels' (the longer at F32_GATED's forwards and
F32_BWD_GATED's backwards); a kernel time
under its bound is profiled again and fails the run if it stays there (unless
the work fits in the L2 cache); a profile of three warm requests,
of one training step, of one B = 512 step with remat, of one ViT-B/32
step at B = 96 and of one 448 px step at B = 24. The build prints
each kernel's registers and spills (ptxas) and, where `cuobjdump` exists, the count of tensor-core
instructions (HMMA, HGMMA) and TMA instructions in each kernel; the bf16
attention kernels and the bf16 grouping kernel must have tensor-core
instructions, and every instance of the one-pass and the cluster forward
and backward and of the float32 TF32x3 forward and backward and of the long forward HGMMA and TMA
ones too (the TF32x3 instances and the long kernel no ptxas spills). The
forward's and the backward's launches by route (one-pass, cluster, long,
TF32x3, two-pass) are printed per phase of the main path (phases 2-14;
phase 9's ranks and phase 10's studies report their own); all ten routed
kernels must have launched, the cluster ones in phase 2 (the 224×336
request) and phase 12 (448 px, ViT-L/14's cross blocks), the long forward
only in phase 2 (the 448×672 and 224×2048 requests) and phase 12 (the 672
px step), every float32 forward
on the TF32x3 kernel, no forward or backward on the two-pass kernels,
every float32 backward of at most 256 keys on the TF32x3 backward, and
the long backwards only in phase 12 (the TF32x3 long one on the float32
ViT-L/14 and 448 px steps, the bf16 one on the 672 px step). The profiles list the
port's own kernels (those in the `segclip_kernels` namespace) apart from
PyTorch's.

`python3 chip_smoke.py study <name> <result.json> <argv...>` is phase
10's subprocess: one study with the launch counters read around it.
`python3 chip_smoke.py long-requests` times and profiles the 448×672 and
224×2048 whole requests alone, in bf16 and float32 (it runs on older trees
of the port too).
`python3 chip_smoke.py profile-step 448` profiles one warm training step
of a LARGE_CONFIGS entry alone, and `python3 chip_smoke.py float32-paths`
times and profiles phase 3's float32 request, phase 8's float32 batched
decode and phase 5's float32 step alone (both run on older trees of the
port too).

Exits non-zero when there is no CUDA card or any check fails. Prints the
card's name and power limit, whether cv2 is importable, one JSON line of
kernel results ("ms", "plain_ms", "library_ms", "bound_ms" at each
kernel's main shape: the one-pass forward ("attention_fwd_one_pass", with
"two_pass_ms" and "host_us") at 96x196 with P, the float32 TF32x3 forward
("attention_fwd_tf32x3", with "two_pass_ms", the SIMT kernel's time in turns
beside it, "host_us", "p_max_abs_err"; "library_ms" SDPA at float32 with
TF32 off) at 96x196 with P, the cluster forward
("attention_fwd", with "two_pass_ms" and "host_us") and PR 3's two-pass
forward (its "two_pass_ms", timed in turns beside it) at 448 px's
24x784 with P, the long forward ("attention_fwd_long", with "two_pass_ms",
PR 3's kernel in turns, and "host_us") at 1x1176, the one-pass backward
("attention_bwd_one_pass", with "two_pass_ms", "host_us" and "pair_ms",
the forward with P plus the backward, beside SDPA's forward + backward)
at 96x196, the cluster
backward ("attention_bwd", with "two_pass_ms" and "pair_ms") at 24x784,
the bf16 long backward ("attention_bwd_long", with "two_pass_ms", the
mma.sync pair in turns, "pair_ms" and "host_us") at 672 px's 4x1764, the float32
TF32x3 long backward ("attention_bwd_tf32x3_long", with "two_pass_ms", the
SIMT pair in turns, "pair_ms" and "host_us") at the float32 448 px step's
2x784, the float32 TF32x3
backward ("attention_bwd_tf32x3", with "two_pass_ms", the SIMT pair in
turns beside it, "pair_ms", the TF32x3 forward with P plus the backward,
beside SDPA's float32 forward + backward, and "host_us") at 96x196, whose
launches are counted by route per phase as above; the Gumbel grouping's at
the MAE shape as
"mae_*"; launches per training step
and per eval request, and by path: "eval" (phase 2), "train" (phase 4),
"train_cli" (phase 6's run A), "train_cli_device_aug" (phase 6's run C,
both segments), "demo" (phase 7), "eval_sharded" (phase 8,
both ranks of its CLI run included), "train_dp" (phase 9, both ranks),
"train_tp" (phase 9's dp1 × tp2 steps, with and without remat, and CLI
run, both ranks), "studies" (phase 10, every study), "train_remat" (phase
12's B = 96 and 256 runs, both ways), "train_b512", "train_l14",
"train_448" and "train_cli_runM" (phase 12), "eval_b32", "train_b32" and
"train_cli_b32" (phase 13), "drift" (phase 14); "train_l14_f32",
"train_448_f32" and "train_672", phase 12's float32 ViT-L/14, float32
448 px and bf16 672 px steps), each kernel's figures at
its ViT-B/32 training (or slide eval) shape as "b32_*", and as its last
line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "table", "dog", "horse", "motorbike", "person", "plant",
    "sheep", "sofa", "train", "monitor")
VOC_BG_THRESH = 0.80

ATTN_SRC = "segclip_tpu_torch/csrc/attention_fwd.cu"
ATTN_BWD_SRC = "segclip_tpu_torch/csrc/attention_bwd.cu"
ATTN_TF32_SRC = "segclip_tpu_torch/csrc/attention_fwd_tf32x3.cu"
ATTN_LONG_SRC = "segclip_tpu_torch/csrc/attention_fwd_long.cu"
ATTN_BWD_TF32_SRC = "segclip_tpu_torch/csrc/attention_bwd_tf32x3.cu"
ATTN_BWD_LONG_SRC = "segclip_tpu_torch/csrc/attention_bwd_long.cu"
GROUP_SRC = "segclip_tpu_torch/csrc/group_assign.cu"
ATTN_TPU = "segclip_tpu/ops/pallas/attention.py:60"
ATTN_BWD_TPU = "segclip_tpu/ops/pallas/attention.py:96"
GROUP_TPU = "segclip_tpu/ops/pallas/grouping.py:45"
GROUP_ST_TPU = "segclip_tpu/ops/pallas/grouping.py:45 (training=True, entry :158)"

# Phase 8: eight images of mixed sizes (H, W), short side ≥ 224, in the
# order the evaluator takes them; at 4 per call their slide windows (224,
# stride 224) come to 1+2+2+2 = 7 and 3+2+2+4 = 11 per decode call.
SHARDED_IMAGES = ((224, 224), (224, 300), (300, 224), (224, 448),
                  (224, 467), (224, 299), (299, 224), (224, 700))
SHARDED_PER_CALL = 4
WARM_REQUESTS = 7           # phase 2's warm runs of each request, after its counted one
SHARDED_MAX_WINDOWS = 11
# Attention shapes of the path: (name, B, Lq, Lk, heads, bias, kind).
ATTN_CASES = (
    ("vision 2x196 (slide, 2 windows)", 2, 196, 196, 12, None, "self"),
    ("vision 1x294 (whole 224x336)", 1, 294, 294, 12, None, "self"),
    ("cross 1x8x302 (whole 224x336, 294 patches)", 1, 8, 302, 12, None, "cross"),
    ("cross 2x8x204", 2, 8, 204, 12, None, "cross"),
    ("group stage 2x8x8", 2, 8, 8, 12, None, "self"),
    ("text 20x77 causal", 20, 77, 77, 8, "causal", "self"),
    ("text 4x77 padding (off the path)", 4, 77, 77, 8, "padding", "self"),
    # phase 8's batched eval decode: the windows of 4 images in one call,
    # 11 at most (SHARDED_IMAGES)
    ("sharded eval vision 11x196", SHARDED_MAX_WINDOWS, 196, 196, 12, None, "self"),
    ("sharded eval cross 11x8x204", SHARDED_MAX_WINDOWS, 8, 204, 12, None, "cross"),
    ("sharded eval group stage 11x8x8", SHARDED_MAX_WINDOWS, 8, 8, 12, None, "self"),
    # phase 10's studies: classprobe's batch of 16 center crops, the shape
    # bank (6 names) and the composed bank (48 "{color} {shape}" names)
    ("studies vision 16x196 (classprobe)", 16, 196, 196, 12, None, "self"),
    ("studies cross 16x8x204 (classprobe)", 16, 8, 204, 12, None, "cross"),
    ("studies group stage 16x8x8 (classprobe)", 16, 8, 8, 12, None, "self"),
    ("studies text 6x77 causal (shape bank)", 6, 77, 77, 8, "causal", "self"),
    ("studies text 48x77 causal (composed bank)", 48, 77, 77, 8, "causal", "self"),
    # phase 13's ViT-B/32 requests: 7 × 7 patches per 224-px window
    ("b32 vision 1x49 (whole 224x224)", 1, 49, 49, 12, None, "self"),
    ("b32 vision 2x49 (slide, 2 windows)", 2, 49, 49, 12, None, "self"),
    ("b32 cross 1x8x57", 1, 8, 57, 12, None, "cross"),
    ("b32 cross 2x8x57", 2, 8, 57, 12, None, "cross"),
    ("group stage 1x8x8 (whole)", 1, 8, 8, 12, None, "self"),
    # phase 2's 448x672 and 224x2048 whole requests: rows past CLUSTER_LIMIT
    ("vision 1x1176 (whole 448x672)", 1, 1176, 1176, 12, None, "self"),
    ("cross 1x8x1184 (whole 448x672, 1176 patches)", 1, 8, 1184, 12, None, "cross"),
    ("vision 1x1792 (whole 224x2048)", 1, 1792, 1792, 12, None, "self"),
    ("cross 1x8x1800 (whole 224x2048, 1792 patches)", 1, 8, 1800, 12, None, "cross"),
)
# Phase 1's checks of the rows past 1024 keys beyond ATTN_CASES: P saved at
# the 448x672 request's vision rows, and both biases (the causal bias2d and
# a padding biasb) on a batch of two.
LONG_P_CASE = ("long vision 1x1176 with P", 1, 1176, 1176, 12, None, "self")
LONG_BIAS_CASE = ("long 2x1100 bias2d + biasb", 2, 1100, 1100, 2, "both", "self")
# Attention shapes of the training step at B = 96: forward with P saved
# and backward. The grouping path's vision blocks, cross blocks and group
# stage; the MAE path's 48 kept patches (layers0, layers_mae2) and cross
# blocks over 8 + 48; the text tower's 32 tokens.
TRAIN_ATTN_CASES = (
    ("train vision 96x196", 96, 196, 196, 12, None, "self"),
    ("train cross 96x8x204", 96, 8, 204, 12, None, "cross"),
    ("train group stage 96x8x8", 96, 8, 8, 12, None, "self"),
    ("train MAE vision 96x48", 96, 48, 48, 12, None, "self"),
    ("train MAE cross 96x8x56", 96, 8, 56, 12, None, "cross"),
    ("train text 96x32 causal", 96, 32, 32, 8, "causal", "self"),
)
# Each rank's shapes in phase 9's data-parallel step (2 ranks × 48).
TRAIN_DP_ATTN_CASES = (
    ("train DP vision 48x196", 48, 196, 196, 12, None, "self"),
    ("train DP cross 48x8x204", 48, 8, 204, 12, None, "cross"),
    ("train DP group stage 48x8x8", 48, 8, 8, 12, None, "self"),
    ("train DP MAE vision 48x48", 48, 48, 48, 12, None, "self"),
    ("train DP MAE cross 48x8x56", 48, 8, 56, 12, None, "cross"),
    ("train DP text 48x32 causal", 48, 32, 32, 8, "causal", "self"),
)
# Each rank's shapes in phase 9's dp1 × tp2 steps, each rank holding 6 of
# the 12 vision and cross heads and 4 of the 8 text heads: the bf16 steps at
# B = 48 (checked), and the train CLI at B = 96 on both ranks (checked and
# profiled, beside the 12- and 8-head rows of TRAIN_ATTN_CASES).
TRAIN_TP_ATTN_CASES = (
    ("train TP vision 48x196 H6", 48, 196, 196, 6, None, "self"),
    ("train TP cross 48x8x204 H6", 48, 8, 204, 6, None, "cross"),
    ("train TP group stage 48x8x8 H6", 48, 8, 8, 6, None, "self"),
    ("train TP MAE vision 48x48 H6", 48, 48, 48, 6, None, "self"),
    ("train TP MAE cross 48x8x56 H6", 48, 8, 56, 6, None, "cross"),
    ("train TP text 48x32 causal H4", 48, 32, 32, 4, "causal", "self"),
    ("train TP vision 96x196 H6", 96, 196, 196, 6, None, "self"),
    ("train TP cross 96x8x204 H6", 96, 8, 204, 6, None, "cross"),
    ("train TP group stage 96x8x8 H6", 96, 8, 8, 6, None, "self"),
    ("train TP MAE vision 96x48 H6", 96, 48, 48, 6, None, "self"),
    ("train TP MAE cross 96x8x56 H6", 96, 8, 56, 6, None, "cross"),
    ("train TP text 96x32 causal H4", 96, 32, 32, 4, "causal", "self"),
)
# Grouping shapes of the path: (name, N, G, L, D).
GROUP_CASES = (
    ("eval 2x8x196x768 (slide)", 2, 8, 196, 768),
    ("eval 1x8x196x768 (whole 224x224)", 1, 8, 196, 768),
    ("eval 1x8x294x768 (whole 224x336)", 1, 8, 294, 768),
    ("eval 1x8x1176x768 (whole 448x672)", 1, 8, 1176, 768),
    ("sharded eval 11x8x196x768", SHARDED_MAX_WINDOWS, 8, 196, 768),
    ("studies 16x8x196x768 (classprobe)", 16, 8, 196, 768),
    ("b32 eval 2x8x49x768 (slide)", 2, 8, 49, 768),
    ("b32 eval 1x8x49x768 (whole 224x224)", 1, 8, 49, 768),
)
GROUP_ST_CASES = (
    ("train 96x8x196x768", 96, 8, 196, 768),
    ("train MAE 96x8x48x768", 96, 8, 48, 768),
    ("train DP 48x8x196x768", 48, 8, 196, 768),
    ("train DP MAE 48x8x48x768", 48, 8, 48, 768),
)
TRAIN_BATCH = 96            # the JAX bench's per-chip batch
TRAIN_STEPS = 5             # timed, after one cold step
# Phase 12: the JAX package's training configurations that need memory
# (scripts/grouping_ab.py:13-18, "b256", "l14" and "res448";
# scripts/runM_batch192.sh, run M) and its largest recorded batch, each
# from a seeded init on phase 4's synthetic batch at its size, bf16:
# name → (CLIP arch, ModelConfig overrides, batch). Phase 1 checks each
# one's training shapes (`step_shapes`) and profiles LARGE_PROFILED's.
# "448_f32" and "672" are image_resolution settings the JAX package takes
# (segclip_tpu/config.py), at the batches one card steps in a few seconds:
# a float32 448 px step (784 patches, cross 792: the float32 backward past
# 256 keys) and a bf16 672 px step (1764 patches, cross 1772: the bf16
# backward past 1024 keys).
LARGE_CONFIGS = {
    "b512": ("ViT-B/16", {}, 512),
    "b256": ("ViT-B/16", {}, 256),
    "runM": ("ViT-B/16", {}, 192),
    "l14": ("ViT-L/14", {}, 32),
    "448": ("ViT-B/16", {"image_resolution": 448}, 24),
    "448_f32": ("ViT-B/16", {"image_resolution": 448, "compute_dtype": "float32"}, 2),
    "672": ("ViT-B/16", {"image_resolution": 672}, 4),
}
LARGE_PROFILED = ("b512", "l14", "448", "672")
# Phase 12's float32 ViT-L/14 step (the reference's precision at the large
# preset): its batch; its cross blocks (8 + 256 keys) are past the TF32x3
# backward's limit and take the TF32x3 long backward.
L14_F32_BATCH = 2
# Phase 13: ViT-B/32 (CLIP_ARCH_PRESETS: patch 32, a 7 × 7 grid at 224 px),
# what `cli.train --clip-arch ViT-B/32` trains, from a seeded init at
# TRAIN_BATCH; phase 1 checks its training shapes and profiles those of its
# vision and cross blocks and of its Gumbel grouping.
B32_ARCH = "ViT-B/32"
# Phase 14: the JAX package's 12-step float32 trajectory
# (tests/test_training_drift.py), its init, batch and every step's random
# draws recorded from JAX's own run by tests/test_torch_drift.py; each
# step's loss must stay within that test's bound of JAX's.
DRIFT_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                             "fixtures", "torch_drift.npz")
DRIFT_RTOL = 5e-4
LARGE_STEPS = 3             # timed, after one cold step
LARGE_REPS = 10             # CUDA-event calls per phase-1 time at these shapes
# Remat against no remat at B = 96: bit for bit is expected (the same ops
# on the same inputs; no port kernel has float atomics). Held to phase 6's
# resume tolerances: each loss within RESUME_LOSS_RTOL of itself, and the
# first step's gradients before the optimizer, per tensor, within
# REMAT_GRAD_RTOL·max|g| (an order of fp32 rounding).
REMAT_GRAD_RTOL = 1e-6
# Run M through cli.train: scripts/runM_batch192.sh's options at B = 192,
# its corpus cut to RUNM_TRAIN_N scenes (two captions each: two steps per
# epoch) and its 6 epochs to RUNM_EPOCHS, one per call.
RUNM_TRAIN_N, RUNM_EPOCHS = 192, 2
# Tolerances, kernel against plain on the same inputs (bf16 distances in
# ulps of the plain value, as segclip_tpu_torch/ops/kernels/checks.py
# defines them and explains the attention bound):
#  - attention float32: max |err| ≤ 2e-5 (only the order of fp32 sums
#    differs);
#  - attention bfloat16: at most a share ATTN_BF16_SHARE of the outputs
#    more than one ulp apart, and max |err| ≤ 2e-2 (a P entry rounded to the
#    neighbouring bf16 value moves o by ≤ 2^-8·|v|, |v| < 5);
#  - attention bfloat16, the rounded-P case: equal bit for bit;
#  - grouping soft: max |err| ≤ 1e-4 (fp32 logits over D=768 summed in
#    another order);
#  - grouping out, against the plain aggregation of the kernel's own
#    assignment: max |err| ≤ 1e-5 in float32, every element within one ulp
#    in bfloat16;
#  - grouping hard: equal on every patch whose top-2 logits differ by more
#    than NEAR_TIE.
#  - attention backward float32: per output, max |err| ≤ 1e-5·(1 + max|ref|)
#    (fp32 sums of products in another order);
#  - attention backward bfloat16: at most a share ATTN_BF16_SHARE of each
#    output more than one ulp apart — each element is one fp32 sum rounded
#    once to bf16, so only values near a rounding midpoint can differ, and D
#    (summed in another order) moves dS by fp32 ulps only;
#  - saved P: float32 max |err| ≤ 1e-5; bfloat16 within the same share rule;
#  - Gumbel grouping: soft and out as the eval grouping, y_soft max |err|
#    ≤ 1e-4, hard equal away from near ties of the noised logits.
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
BWD_REL_TOL_F32 = 1e-5
P_TOL_F32 = 1e-5
SOFT_TOL = 1e-4
YSOFT_TOL = 1e-4
OUT_TOL_F32 = 1e-5
NEAR_TIE = 1e-3
TAU = 0.9                   # ModelConfig.gumbel_tau
# Phase 5: float32 training step, card vs CPU: the loss within this share
# of itself; gradients, where no patch is near a tie, per tensor within
# TRAIN_GRAD_TOL·(1 + max|g|) (fp32 sums in another order through ~30
# blocks forward and back).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-4
# Phase 3: float32 whole-image logits on the card and on the CPU.
E2E_PIXEL_TOL = 1e-3        # a pixel agrees if every class logit is within this
E2E_MIN_AGREE = 0.999       # share of pixels that must agree, and argmax-agree
# The float32 shapes at which the TF32x3 forward is timed against PR 1's
# SIMT kernel (in turns, ROUTE_ROUNDS rounds) and SDPA in the device-time
# section: the B = 96 step's (and a TP rank's vision blocks, H = 6), the
# 224x224 slide and 224x336 whole requests', the drift replay's one-head
# MAE blocks (L = 3), and the rows past 1024 keys of the 448x672 and
# 224x2048 whole requests (which the SIMT kernel took before the TF32x3
# kernel's length limit was lifted), and phase 12's float32 ViT-L/14 cross
# rows and float32 448 px step's rows (whose backward is the TF32x3 long
# kernels', timed beside the SIMT pair they replaced and SDPA's float32
# forward + backward); at F32_GATED the TF32x3 kernel must be the faster.
# At bf16 every routed kernel is gated against the two-pass one.
F32_TIMED = ("train vision 96x196", "train TP vision 96x196 H6", "train cross 96x8x204",
             "train MAE vision 96x48", "train MAE cross 96x8x56", "train text 96x32 causal",
             "train group stage 96x8x8", "vision 2x196 (slide, 2 windows)", "cross 2x8x204",
             "text 20x77 causal", "vision 1x294 (whole 224x336)",
             "cross 1x8x302 (whole 224x336, 294 patches)", "drift MAE vision",
             "vision 1x1176", "cross 1x8x1184", "vision 1x1792", "cross 1x8x1800",
             "l14 float32 cross 2x8x264", "448_f32 vision 2x784", "448_f32 cross 2x8x792")
F32_GATED = ("train vision 96x196", "train cross 96x8x204", "vision 2x196 (slide, 2 windows)",
             "vision 1x1176 (whole 448x672)", "cross 1x8x1184 (whole 448x672, 1176 patches)")
# The float32 backward shapes at which the TF32x3 backward (and, past 256
# keys, the TF32x3 long backward) must beat the SIMT pair (F32_TIMED's
# training shapes time both, in turns).
F32_BWD_GATED = ("train vision 96x196", "train cross 96x8x204", "train TP vision 96x196 H6",
                 "l14 float32 cross 2x8x264 H16", "448_f32 vision 2x784 H12",
                 "448_f32 cross 2x8x792 H12")
PROFILE_TRIES = 3           # profiler runs before a time falls back to CUDA events
L2_BYTES = 50e6             # the H100's L2 cache
HOST_ROUNDS = 5             # rounds of host_us per forward route
ROUTE_ROUNDS = 3            # rounds, in turns, of the one-pass and two-pass device times
# Phase 6: the shapes corpus (96 scenes, two captions each: 192 samples, two
# B = 96 steps per epoch) and its eval split; the loader timed alone over
# LOADER_EPOCHS warm epochs after a cold one, once in each transport (as the
# DataConfig settings that select it).
CORPUS_TRAIN_N, CORPUS_EVAL_N = 96, 4
LOADER_WORKERS, LOADER_EPOCHS = 4, 3
TRANSPORTS = {"rgb": dict(transfer="rgb"), "yuv420": dict(transfer="yuv420"),
              "device_aug": dict(transfer="rgb", device_aug=True)}
# Phase 11: the device transforms, card vs CPU on phase 6's batches:
# yuv420_to_rgb (float32, no rounding: sums in another order) within
# YUV_TOL on the [0, 255] scale; crop_resize_batch within one uint8 level
# (a float32 sum in another order may cross a rounding boundary of the
# rounded, clipped intermediate) on at most CROP_SHARE of the values.
YUV_TOL = 1e-3
CROP_SHARE = 1e-3
# Phase 6, the resumed run against run A's last epoch: bit for bit is
# expected, since every port kernel is free of atomics and the step's noise
# is a function of (seed, step). If a library kernel of PyTorch (cuBLAS,
# an atomic scatter in a backward) sums in another order between the two
# runs, a parameter moves by an order of fp32 rounding of its update
# (|update| ≤ lr·(1 + wd) per step, lr 4e-4 here), so it must stay within
# RESUME_PARAM_TOL, and the loss within RESUME_LOSS_RTOL of itself.
RESUME_PARAM_TOL = 1e-6
RESUME_LOSS_RTOL = 1e-4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def call_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median time of one call on the stream by CUDA events, host launch
    latency included (the card idles while the wrapper runs)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_rows(fn) -> list:
    """Run `fn` under torch.profiler; the per-kernel (and per-copy) rows of
    what ran on the card. Now and then the profiler hands back no device
    record for a run that did launch kernels; such a run is repeated, and
    after PROFILE_TRIES empty runs the result is [] (the caller says so)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if sum(e.self_device_time_total for e in rows) > 0:
            return rows
    return []


def device_ms(fn, reps: int = 20, warmup: int = 3) -> tuple:
    """Device time of one call: the summed durations of every kernel and
    copy it ran on the card, averaged over `reps` calls; and the name of
    the kernel that took most of it. Where the profiler saw nothing, the
    time of the `reps` calls back to back by CUDA events (launch gaps
    included), and None for the name."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(reps):
            fn()

    rows = device_rows(run)
    if not rows:
        print(f"  (the profiler saw no device time in {PROFILE_TRIES} runs: "
              "timed by CUDA events instead)")
        return call_ms(run, reps=3, warmup=0) / reps, None
    top = max(rows, key=lambda e: e.self_device_time_total).key
    return sum(e.self_device_time_total for e in rows) / reps / 1e3, top


def sdpa_backend(kernel_name) -> str:
    """Which backend of scaled_dot_product_attention ran, from the name of
    its largest kernel (None: the profiler saw none)."""
    if kernel_name is None:
        return "not read"
    name = kernel_name.lower()
    for key, backend in (("flash", "flash"), ("cudnn", "cudnn"), ("fmha", "efficient"),
                         ("efficient", "efficient"), ("mem_eff", "efficient")):
        if key in name:
            return backend
    return f"other ({kernel_name[:60]})"


def sdpa_library(q, k, v, bias2d, biasb, do=None):
    """One PyTorch call computing the same attention, timed as a yardstick
    and never called by the port: scaled_dot_product_attention on the
    head-split views of the same (B, L, H·64) inputs, is_causal for the
    causal mask and a float attn_mask for the padding bias. With `do`, its
    forward and backward under autograd (it saves no P, so it is compared
    with the kernels' forward-with-P plus backward)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    heads = q.shape[-1] // 64

    def split(t):
        return t.view(t.shape[0], t.shape[1], heads, 64).transpose(1, 2)

    kw = {}
    if bias2d is not None:
        kw["is_causal"] = True                    # the only bias2d of the path
    if biasb is not None:
        kw["attn_mask"] = biasb[:, None, None, :].to(q.dtype)
    if do is None:
        qh, kh, vh = split(q), split(k), split(v)

        def forward():
            with torch.no_grad():
                return sdpa(qh, kh, vh, **kw)
        return forward
    qh, kh, vh = (split(t).detach().requires_grad_() for t in (q, k, v))
    doh = split(do)

    def forward_backward():
        return torch.autograd.grad(sdpa(qh, kh, vh, **kw), (qh, kh, vh), doh)
    return forward_backward


def attention_inputs(case, dtype, dev, gen):
    _, b, lq, lk, h, bias, kind = case
    d = h * 64

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    if kind == "self":                 # column views of a packed projection
        qkv = randn(b, lq, 3 * d)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    else:
        q = randn(b, lq, d)
        kv = randn(b, lk, 2 * d)
        k, v = kv[..., :d], kv[..., d:]
    bias2d = biasb = None
    if bias in ("causal", "both"):
        from segclip_tpu_torch.ops.attention import causal_mask
        bias2d = causal_mask(lq, device=dev)
    if bias in ("padding", "both"):
        lens = torch.randint(3, lk + 1, (b,), generator=gen, device=dev)
        mask = (torch.arange(lk, device=dev)[None] < lens[:, None]).float()
        biasb = (1.0 - mask) * -1e6
    return q, k, v, bias2d, biasb


def check_route(case, dtype, before: dict, backward: bool = False) -> str:
    """The route one forward (or backward) call took, from the route
    counters moved since `before`, which must be the one `fwd_route` (or
    `bwd_route`) names for its dtype and Lk with the library's limits."""
    from segclip_tpu_torch.ops.kernels.attention import (
        bwd_cluster_limit, bwd_long_min_lk, bwd_one_pass_limit, bwd_route, bwd_tf32x3_limit,
        cluster_limit, fwd_route, long_min_lk, one_pass_limit)
    if backward:
        check(bwd_long_min_lk("long") == bwd_cluster_limit() + 1
              and bwd_long_min_lk("tf32x3_long") == bwd_tf32x3_limit() + 1,
              f"the long backwards start at {bwd_long_min_lk('long')} (bf16) and "
              f"{bwd_long_min_lk('tf32x3_long')} (float32) keys, the cluster and TF32x3 "
              f"backwards end at {bwd_cluster_limit()} and {bwd_tf32x3_limit()}")
        route = bwd_route(dtype, case[3], bwd_one_pass_limit(), bwd_cluster_limit(),
                          bwd_tf32x3_limit())
        prefix, keys = "bwd_", BWD_ROUTES
    else:
        check(long_min_lk() == cluster_limit() + 1, f"the long kernel starts at "
              f"{long_min_lk()} keys, the cluster kernel ends at {cluster_limit()}")
        route = fwd_route(dtype, case[3], one_pass_limit(), cluster_limit())
        prefix, keys = "", ROUTES
    now = read_routes()
    moved = {k: now[prefix + k] - before[prefix + k] for k in keys}
    check(moved == {k: int(route == k) for k in keys},
          f"attention {'backward' if backward else 'forward'} {case[0]} {dtype}: routes "
          f"moved {moved}, expected one {route} launch")
    return route


def two_pass_beside(case, inputs: tuple, save_p: bool, ref, p_ref, reps: int = 50) -> tuple:
    """At a shape the one-pass, the cluster, the long or the TF32x3 kernel
    takes: the two-pass kernel (PR 3's bf16 kernel, PR 1's float32 SIMT
    kernel) on the same inputs, held to the plain version by the same rules
    (bf16: max |err| and the >1-ulp share of out, and of P when saved;
    float32: max |err| of out, and of P when saved). Returns its call, a note with its
    time per call by CUDA events, and its max |err|."""
    from segclip_tpu_torch.ops.kernels.attention import attention_fwd_two_pass
    from segclip_tpu_torch.ops.kernels.checks import ATTN_BF16_SHARE
    fn = functools.partial(attention_fwd_two_pass, *inputs, save_p=save_p)
    out, p = fn()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= ATTN_TOL[out.dtype], f"two-pass {case[0]}: err {err}")
    if out.dtype == torch.float32:
        p_err = (p - p_ref).abs().max().item() if save_p else 0.0
        check(p_err <= P_TOL_F32, f"two-pass {case[0]}: P err {p_err}")
        return fn, (f"; two-pass err {err:.3e}" + (f", P err {p_err:.3e}" if save_p else "")
                    + f", {call_ms(fn, reps=reps):.4f} ms"), err
    shares = [bf16_share(out, ref)] + ([bf16_share(p, p_ref)] if save_p else [])
    for (sh, _), what in zip(shares, ("out", "P")):
        check(sh <= ATTN_BF16_SHARE, f"two-pass {case[0]} bf16 {what}: share {sh}")
    return fn, (f"; two-pass err {err:.3e}, >1 ulp " + "/".join(f"{sh:.1e}" for sh, _ in shares)
                + f", {call_ms(fn, reps=reps):.4f} ms"), err


def bwd_two_pass_beside(case, inputs: tuple, refs, reps: int = 50) -> tuple:
    """At a shape the one-pass, the cluster or the TF32x3 backward takes: the
    two-pass kernels (the bf16 mma.sync pair, the float32 SIMT pair) on the same
    P, dO, q, k, v, held to the plain version by the same rules (finite;
    bf16: the >1-ulp share of dQ, dK and dV; float32: each within
    BWD_REL_TOL_F32·(1 + max|ref|)). Returns its call, a note with its time
    per call by CUDA events, and its max |err| over dQ, dK and dV."""
    from segclip_tpu_torch.ops.kernels.attention import attention_bwd_two_pass
    from segclip_tpu_torch.ops.kernels.checks import ATTN_BF16_SHARE
    fn = functools.partial(attention_bwd_two_pass, *inputs)
    grads = fn()
    torch.cuda.synchronize()
    check(all(torch.isfinite(g).all().item() for g in grads),
          f"two-pass backward {case[0]}: non-finite")
    err = max((g.float() - r.float()).abs().max().item() for g, r in zip(grads, refs))
    if grads[0].dtype == torch.float32:
        rel = [(g - r).abs().max().item() / (1 + r.abs().max().item()) for g, r in zip(grads, refs)]
        check(max(rel) <= BWD_REL_TOL_F32, f"SIMT backward {case[0]}: rel err {rel}")
        return fn, (f"; SIMT bwd rel err {max(rel):.2e}, {call_ms(fn, reps=reps):.4f} ms"), err
    shares = [bf16_share(g, r) for g, r in zip(grads, refs)]
    for (sh, _), what in zip(shares, ("dQ", "dK", "dV")):
        check(sh <= ATTN_BF16_SHARE, f"two-pass backward {case[0]} bf16 {what}: share {sh}")
    return fn, ("; two-pass bwd >1 ulp " + "/".join(f"{sh:.1e}" for sh, _ in shares)
                + f", {call_ms(fn, reps=reps):.4f} ms"), err


def f32_timed(name: str) -> bool:
    return any(name.startswith(n) for n in F32_TIMED)


def host_us(fn, calls: int = 200) -> float:
    """Host time per call with nothing waited for (enqueue only), µs."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return t


def phase_kernels(dev) -> tuple:
    """Phase 1: each kernel against its plain version at the path's shapes.
    Returns the main-shape summary and the calls to time on the device."""
    from segclip_tpu_torch.ops.kernels import bounds
    from segclip_tpu_torch.ops.kernels.attention import attention, attention_plain
    from segclip_tpu_torch.ops.kernels.checks import (ATTN_BF16_SHARE, bf16_ulps,
                                                      rounded_p_case)
    from segclip_tpu_torch.ops.kernels.grouping import group_assign, group_assign_plain

    gen = torch.Generator(device=dev).manual_seed(0)
    summary, timings = {}, []
    print("phase 1: kernels vs plain (max |err|; bf16 distances in ulps of "
          "the plain value; ms kernel / plain: median time per call by CUDA "
          "events, 50 calls after 5 warm-up, launch included)")
    q, k, v, b2 = rounded_p_case(dev)
    out, ref = attention(q, k, v, b2), attention_plain(q, k, v, b2)
    unrounded = (torch.softmax(b2, -1) @ v[0].float()).to(torch.bfloat16)[None]
    moved = bf16_ulps(unrounded, ref).max().item()
    print(f"  attention rounded-P case (bf16): kernel equals plain bit for bit: "
          f"{torch.equal(out, ref)}; skipping the rounding of P would move "
          f"o by {moved:g} ulps")
    check(moved >= 2, "the rounded-P case no longer tells the chains apart")
    check(torch.equal(out, ref), "attention: P is not rounded to bf16 before P·V")
    for dtype in (torch.float32, torch.bfloat16):
        for case in ATTN_CASES:
            q, k, v, b2, bb = attention_inputs(case, dtype, dev, gen)
            routes = read_routes()
            out = attention(q, k, v, b2, bb)
            route = check_route(case, dtype, routes)
            ref = attention_plain(q, k, v, b2, bb)
            torch.cuda.synchronize()
            check(torch.isfinite(out).all().item(), f"attention {case[0]}: non-finite")
            err = (out.float() - ref.float()).abs().max().item()
            kernel = functools.partial(attention, q, k, v, b2, bb)
            plain = functools.partial(attention_plain, q, k, v, b2, bb)
            call, plain_call = call_ms(kernel), call_ms(plain)
            two_pass, two_note = None, ""
            if route != "two_pass" and (dtype == torch.bfloat16 or f32_timed(case[0])):
                two_pass, two_note, _ = two_pass_beside(case, (q, k, v, b2, bb), False, ref, None)
            _, b, lq, lk, h, bias, _ = case
            work = bounds.attention_fwd_work(b, lq, lk, h, dtype, save_p=False,
                                             bias2d=b2 is not None, biasb=bb is not None)
            tol = ATTN_TOL[dtype]
            ulp_note = ""
            if dtype == torch.bfloat16:
                ulps = bf16_ulps(out, ref)
                share = (ulps > 1).float().mean().item()
                ulp_note = (f", >1 ulp on {share:.2e} of outputs (max "
                            f"{ulps.max().item():.1f} ulps)")
                check(share <= ATTN_BF16_SHARE,
                      f"attention {case[0]} bf16: {share} of outputs > 1 ulp")
            print(f"  attention {case[0]:34s} {str(dtype)[6:]:8s} {route} err {err:.3e} "
                  f"(tol {tol:g}){ulp_note}  {call:.4f} / {plain_call:.4f} ms{two_note}")
            check(err <= tol, f"attention {case[0]} {dtype}: err {err} > {tol}")
            timings.append(dict(name=f"attention {case[0]} {str(dtype)[6:]}", kernel=kernel,
                                plain=plain, work=(*work, dtype), two_pass=two_pass,
                                gate=dtype == torch.bfloat16 or case[0] in F32_GATED,
                                library=sdpa_library(q, k, v, b2, bb)))
            if case is ATTN_CASES[0] and dtype == torch.bfloat16:
                summary["attention"] = dict(max_abs_err=err, timing=len(timings) - 1)
            if case[0].startswith("vision 1x1176") and dtype == torch.bfloat16:
                summary["attention_fwd_long"] = dict(max_abs_err=err, timing=len(timings) - 1)

        for name, n, g, l, d in GROUP_CASES:
            q = torch.randn(n, g, d, generator=gen, device=dev).to(dtype)
            k = torch.randn(n, l, d, generator=gen, device=dev).to(dtype)
            v = torch.randn(n, l, d, generator=gen, device=dev).to(dtype)
            out, hard, soft = group_assign(q, k, v)
            _, hard_ref, soft_ref = group_assign_plain(q, k, v)
            same = all(torch.equal(a, b) for a, b in zip((out, hard, soft), group_assign(q, k, v)))
            torch.cuda.synchronize()
            logits = torch.matmul(q.double(), k.double().transpose(1, 2))
            top2 = logits.topk(2, dim=1).values
            near = (top2[:, 0] - top2[:, 1]) < NEAR_TIE               # (N, L)
            differ = (hard != hard_ref).any(dim=1)                    # (N, L)
            n_near, n_bad = int(near.sum()), int((differ & ~near).sum())
            soft_err = (soft - soft_ref).abs().max().item()
            counts = hard.sum(-1, keepdim=True).clamp(min=1.0)
            out_ref = (torch.matmul(hard, v.float()) / counts).to(dtype)
            out_err = (out.float() - out_ref.float()).abs().max().item()
            if dtype == torch.bfloat16:
                out_ulps = bf16_ulps(out, out_ref).max().item()
                out_ok, out_note = out_ulps <= 1, f" ({out_ulps:g} ulps)"
            else:
                out_ok, out_note = out_err <= OUT_TOL_F32, ""
            kernel = functools.partial(group_assign, q, k, v)
            plain = functools.partial(group_assign_plain, q, k, v)
            call, plain_call = call_ms(kernel), call_ms(plain)
            print(f"  grouping  {name:34s} {str(dtype)[6:]:8s} soft err {soft_err:.3e} "
                  f"out err {out_err:.3e}{out_note}; hard differs on "
                  f"{int(differ.sum())} patches, {n_near} near-tie patches "
                  f"(margin < {NEAR_TIE:g}); run twice bit-identical: {same}  "
                  f"{call:.4f} / {plain_call:.4f} ms")
            check(same, f"grouping {name} {dtype}: a second call gave other bits")
            check(n_bad == 0, f"grouping {name}: hard differs on {n_bad} clear patches")
            check(soft_err <= SOFT_TOL, f"grouping {name}: soft err {soft_err}")
            check(out_ok, f"grouping {name} {dtype}: out err {out_err}{out_note}")
            check(int(hard.sum()) == n * l, f"grouping {name}: hard is not one-hot")
            timings.append(dict(name=f"grouping {name} {str(dtype)[6:]}", kernel=kernel,
                                plain=plain, library=None,
                                work=(*bounds.group_assign_work(n, g, l, d, dtype, False),
                                      dtype)))
            if name in (GROUP_CASES[0][0], "b32 eval 2x8x49x768 (slide)") \
                    and dtype == torch.bfloat16:
                summary["grouping" if name == GROUP_CASES[0][0] else "b32_grouping"] = dict(
                    max_abs_err=out_err, timing=len(timings) - 1)
    long_rows(dev, gen, summary, timings)
    training_kernels(dev, gen, summary, timings)
    host_costs(dev, gen, summary)
    repaired_fault(dev)
    return summary, timings


def long_rows(dev, gen, summary, timings) -> None:
    """Phase 1, rows past 1024 keys beyond ATTN_CASES: the forward kernels'
    branch-free division (hopper.cuh div_normal) equal to IEEE `/` over
    every significand of l in [1, 2) scaled by 2^0..2^13 (every l of a row
    of up to 16384 keys, by the exponent scaling of its proof), p random in
    [2^-100, 1]; then in both dtypes, at LONG_P_CASE with P saved and at
    LONG_BIAS_CASE with bias2d and biasb, the routed forward (the long
    kernel at bf16, the TF32x3 kernel at float32) against the plain version
    under the phase's tolerances, O the same bits with and without P, and
    P's columns [Lk, Lk8) zero; and from that P the routed backward (the
    long backward at bf16, the TF32x3 long backward at float32) against the
    plain version under the training shapes' rules, the same bits over two
    calls, timed (at LONG_P_CASE, in both dtypes: the forward with P, and
    the backward beside the two-pass pair it replaced, which must be the
    slower)."""
    from segclip_tpu_torch.ops.kernels import bounds
    from segclip_tpu_torch.ops.kernels.attention import (attention_bwd, attention_bwd_plain,
                                                         attention_fwd, attention_fwd_plain,
                                                         division_check)
    from segclip_tpu_torch.ops.kernels.checks import ATTN_BF16_SHARE
    sig = 1 + torch.arange(2 ** 23, device=dev, dtype=torch.float64) / 2 ** 23
    bad = 0
    for e in range(14):
        l = (sig * 2.0 ** e).float()
        p = torch.exp2(-100 * torch.rand(l.shape, generator=gen, device=dev))
        p[:2] = torch.tensor([1.0, 2.0 ** -100], device=dev)
        fast, ieee = division_check(p, l)
        bad += int((fast.view(torch.int32) != ieee.view(torch.int32)).sum())
    print(f"  division: div_normal against IEEE / on {14 * 2 ** 23} pairs (every significand "
          f"of l in [1, 2) at 2^0..2^13, p in [2^-100, 1]): {bad} differ")
    check(bad == 0, f"div_normal differs from IEEE division on {bad} pairs")
    for dtype in (torch.float32, torch.bfloat16):
        for case in (LONG_P_CASE, LONG_BIAS_CASE):
            q, k, v, b2, bb = attention_inputs(case, dtype, dev, gen)
            routes = read_routes()
            out, p = attention_fwd(q, k, v, b2, bb, save_p=True)
            route = check_route(case, dtype, routes)
            bare, none = attention_fwd(q, k, v, b2, bb)
            ref, p_ref = attention_fwd_plain(q, k, v, b2, bb)
            torch.cuda.synchronize()
            lk = case[3]
            full = p.as_strided((*p.shape[:3], (lk + 7) // 8 * 8), p.stride())
            err = (out.float() - ref.float()).abs().max().item()
            p_err = (p.float() - p_ref.float()).abs().max().item()
            note = ""
            if dtype == torch.bfloat16:
                shares = [bf16_share(out, ref), bf16_share(p, p_ref)]
                note = "; >1 ulp share out/P " + " ".join(f"{sh:.1e}" for sh, _ in shares)
                for (sh, _), what in zip(shares, ("out", "P")):
                    check(sh <= ATTN_BF16_SHARE, f"{case[0]} bf16 {what}: share {sh}")
            else:
                check(p_err <= P_TOL_F32, f"{case[0]} float32: P err {p_err}")
            print(f"  attention {case[0]:34s} {str(dtype)[6:]:8s} {route} err {err:.3e}, P err "
                  f"{p_err:.3e}{note}; O same bits without P: {torch.equal(out, bare)}")
            check(route == ("long" if dtype == torch.bfloat16 else "tf32x3"),
                  f"{case[0]} {dtype}: route {route}")
            check(torch.isfinite(out).all().item() and err <= ATTN_TOL[dtype],
                  f"{case[0]} {dtype}: err {err}")
            check(none is None and torch.equal(out, bare), f"{case[0]} {dtype}: O differs "
                  "with and without P")
            check(torch.equal(full[..., lk:], torch.zeros_like(full[..., lk:])),
                  f"{case[0]} {dtype}: P's padding columns are not zero")
            if case is LONG_P_CASE and dtype == torch.bfloat16:
                summary["attention_fwd_long"]["p_err"] = p_err

            do = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
            routes = read_routes()
            grads = attention_bwd(p, do, q, k, v)
            bwd_route = check_route(case, dtype, routes, backward=True)
            again = attention_bwd(p, do, q, k, v)
            refs = attention_bwd_plain(p, do, q, k, v)
            torch.cuda.synchronize()
            check(bwd_route == ("long" if dtype == torch.bfloat16 else "tf32x3_long"),
                  f"{case[0]} {dtype}: backward route {bwd_route}")
            check(all(torch.isfinite(g).all().item() for g in grads)
                  and all(torch.equal(g, h) for g, h in zip(grads, again)),
                  f"{case[0]} {dtype}: the backward is not finite or not the same bits twice")
            if dtype == torch.bfloat16:
                shares = [bf16_share(g, r) for g, r in zip(grads, refs)]
                note = "; >1 ulp share dQ/dK/dV " + " ".join(f"{sh:.1e}" for sh, _ in shares)
                for (sh, _), what in zip(shares, ("dQ", "dK", "dV")):
                    check(sh <= ATTN_BF16_SHARE, f"{case[0]} bf16 {what}: share {sh}")
            else:
                rel = [(g - r).abs().max().item() / (1 + r.abs().max().item())
                       for g, r in zip(grads, refs)]
                note = "; rel err dQ/dK/dV " + " ".join(f"{x:.2e}" for x in rel)
                check(max(rel) <= BWD_REL_TOL_F32, f"{case[0]} float32: backward rel err {rel}")
            if case is not LONG_P_CASE:
                print(f"  attention bwd {case[0]:30s} {str(dtype)[6:]:8s} {bwd_route}{note}; "
                      "same bits twice")
                continue
            two, two_note, _ = bwd_two_pass_beside(case, (p, do, q, k, v), refs, LARGE_REPS)
            print(f"  attention bwd {case[0]:30s} {str(dtype)[6:]:8s} {bwd_route}{note}; same "
                  f"bits twice; {call_ms(lambda: attention_bwd(p, do, q, k, v), LARGE_REPS):.4f} "
                  f"ms{two_note}")
            _, b, lq, lk, h, _, _ = case
            timings.append(dict(
                name=f"attention fwd+P {case[0]} {str(dtype)[6:]}",
                kernel=functools.partial(attention_fwd, q, k, v, save_p=True),
                plain=functools.partial(attention_fwd_plain, q, k, v), two_pass=None,
                work=(*bounds.attention_fwd_work(b, lq, lk, h, dtype, save_p=True), dtype),
                library=sdpa_library(q, k, v, None, None)))
            timings.append(dict(
                name=f"attention bwd {case[0]} {str(dtype)[6:]}",
                kernel=functools.partial(attention_bwd, p, do, q, k, v),
                plain=functools.partial(attention_bwd_plain, p, do, q, k, v), two_pass=two,
                gate=True, work=(*bounds.attention_bwd_work(b, lq, lk, h, dtype), dtype),
                library=sdpa_library(q, k, v, None, None, do), pair=len(timings) - 1))


def host_costs(dev, gen, summary) -> None:
    """Host µs per forward call with P and per backward call (enqueue only,
    nothing waited for) at the B = 96 vision shape, through each routed
    wrapper and through the one-pass and two-pass routes' own functions, and
    at 448 px's 24×784 through the cluster route's; into summary["host_us"]
    and summary["bwd_host_us"] (the cluster route's under "cluster"); and at
    the B = 96 vision shape in float32, per forward call with P through the
    TF32x3 and the two-pass route's functions, into summary["f32_host_us"],
    and per float32 backward call through the TF32x3 backward's and the SIMT
    pair's, into summary["f32_bwd_host_us"]; and at the 448x672 request's
    1x1176, per forward call through the long and the two-pass functions
    (bf16, summary["long_host_us"]) and the TF32x3 and two-pass functions
    (float32, summary["f32_long_host_us"]), and per backward call through
    the long and the two-pass functions (bf16, summary["long_bwd_host_us"])
    and the TF32x3 long and two-pass functions (float32,
    summary["f32_long_bwd_host_us"])."""
    from segclip_tpu_torch.ops.kernels import attention as kattn
    shapes = {"one_pass": TRAIN_ATTN_CASES[0],
              "cluster": step_shapes("448", large_config("448", False), LARGE_CONFIGS["448"][2])[0][0]}
    for key in ("host_us", "bwd_host_us"):
        summary[key] = {}
    for kind, case in shapes.items():
        q, k, v, b2, bb = attention_inputs(case, torch.bfloat16, dev, gen)
        out, p = kattn.attention_fwd(q, k, v, b2, bb, save_p=True)
        do = torch.randn(out.shape, generator=gen, device=dev).to(torch.bfloat16)
        routes = ("one_pass", "two_pass") if kind == "one_pass" else ("cluster",)
        for key, what, calls in (
                ("host_us", "forward call with P", {
                    name: functools.partial(getattr(kattn, fn), q, k, v, b2, bb, save_p=True)
                    for name, fn in [("attention_fwd", "attention_fwd")] * (kind == "one_pass")
                    + [(r, f"attention_fwd_{r}") for r in routes]}),
                ("bwd_host_us", "backward call", {
                    name: functools.partial(getattr(kattn, fn), p, do, q, k, v)
                    for name, fn in [("attention_bwd", "attention_bwd")] * (kind == "one_pass")
                    + [(r, f"attention_bwd_{r}") for r in routes]})):
            found = host_us_in_turns(calls)
            summary[key].update(found)
            print(f"  host time per {what} at {case[0]} (enqueue only; median of "
                  f"{HOST_ROUNDS} rounds of 200 calls, in turns): " + ", ".join(
                      f"{k} {v:.1f} us" for k, v in found.items()))
    q, k, v, b2, bb = attention_inputs(TRAIN_ATTN_CASES[0], torch.float32, dev, gen)
    _, p = kattn.attention_fwd(q, k, v, b2, bb, save_p=True)
    do = torch.randn(q.shape, generator=gen, device=dev)
    for key, what, fn, args in (
            ("f32_host_us", "forward call with P", "attention_fwd_{}", (q, k, v, b2, bb)),
            ("f32_bwd_host_us", "backward call", "attention_bwd_{}", (p, do, q, k, v))):
        calls = {r: functools.partial(getattr(kattn, fn.format(r)), *args,
                                      **({"save_p": True} if key == "f32_host_us" else {}))
                 for r in ("tf32x3", "two_pass")}
        summary[key] = host_us_in_turns(calls)
        print(f"  host time per float32 {what} at {TRAIN_ATTN_CASES[0][0]} (enqueue only, in "
              f"turns): " + ", ".join(f"{k} {v:.1f} us" for k, v in summary[key].items()))
    case = next(c for c in ATTN_CASES if c[0].startswith("vision 1x1176"))
    for dtype, key, route, bwd in ((torch.bfloat16, "long_host_us", "long", "long"),
                                   (torch.float32, "f32_long_host_us", "tf32x3", "tf32x3_long")):
        args = attention_inputs(case, dtype, dev, gen)
        summary[key] = host_us_in_turns({r: functools.partial(
            getattr(kattn, f"attention_fwd_{r}"), *args) for r in (route, "two_pass")})
        print(f"  host time per {str(dtype)[6:]} forward call at {case[0]} (enqueue only, in "
              f"turns): " + ", ".join(f"{k} {v:.1f} us" for k, v in summary[key].items()))
        q, k, v = args[:3]
        _, p = kattn.attention_fwd(q, k, v, save_p=True)
        do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        key = key.replace("_host_us", "_bwd_host_us")
        summary[key] = host_us_in_turns({r: functools.partial(
            getattr(kattn, f"attention_bwd_{r}"), p, do, q, k, v) for r in (bwd, "two_pass")})
        print(f"  host time per {str(dtype)[6:]} backward call at {case[0]} (enqueue only, in "
              f"turns): " + ", ".join(f"{k} {v:.1f} us" for k, v in summary[key].items()))


def host_us_in_turns(calls: dict) -> dict:
    """host_us of each call, HOST_ROUNDS rounds in turns (the order reversed
    every round); the median of each."""
    times = {name: [] for name in calls}
    for i in range(HOST_ROUNDS):
        for name in (list(calls) if i % 2 == 0 else list(calls)[::-1]):
            times[name].append(host_us(calls[name]))
    return {name: statistics.median(t) for name, t in times.items()}


def bf16_share(out, ref) -> tuple:
    from segclip_tpu_torch.ops.kernels.checks import bf16_ulps
    ulps = bf16_ulps(out, ref)
    return (ulps > 1).float().mean().item(), ulps.max().item()


def training_kernels(dev, gen, summary, timings) -> None:
    """Phase 1, training shapes: the forward with P saved, the backward from
    that P, and the Gumbel grouping, each against its plain version."""
    from segclip_tpu_torch.ops.kernels import bounds
    from segclip_tpu_torch.ops.kernels.attention import (
        attention_bwd, attention_bwd_plain, attention_fwd, attention_fwd_plain)
    from segclip_tpu_torch.ops.kernels.checks import ATTN_BF16_SHARE
    from segclip_tpu_torch.ops.kernels.grouping import (group_assign_fwd,
                                                        group_assign_st_plain)

    large_attn, large_gumbel, profiled = (), (), set()
    drift = drift_fixture()
    configs = [(name, large_config(name, True), b) for name, (_, _, b) in LARGE_CONFIGS.items()]
    configs += [("b32", b32_config(), TRAIN_BATCH),
                ("drift", drift["cfg"].model, drift["batch"]["image"].shape[0]),
                ("l14 float32", l14_f32_config(), L14_F32_BATCH)]
    shapes = {name: step_shapes(name, cfg, b) for name, cfg, b in configs}
    for name, (attn, gumbel) in shapes.items():
        large_attn, large_gumbel = large_attn + attn, large_gumbel + gumbel
        if name in LARGE_PROFILED + ("b32",):       # the vision and cross blocks, both paths
            profiled.update(c[0] for c in attn[:2] + gumbel)
    b32_attn, b32_gumbel = shapes["b32"]
    f32_only = {c[0] for name in ("l14 float32", "448_f32")      # run only in float32
                for group in shapes[name] for c in group}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        for case in TRAIN_ATTN_CASES + TRAIN_DP_ATTN_CASES + TRAIN_TP_ATTN_CASES + large_attn:
            if dtype == torch.bfloat16 and case[0] in f32_only:
                continue
            reps = LARGE_REPS if case in large_attn else 50
            q, k, v, b2, bb = attention_inputs(case, dtype, dev, gen)
            routes = read_routes()
            out, p = attention_fwd(q, k, v, b2, bb, save_p=True)
            route = check_route(case, dtype, routes)
            ref, p_ref = attention_fwd_plain(q, k, v, b2, bb)
            do = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
            routes = read_routes()
            grads = attention_bwd(p, do, q, k, v)
            bwd_route = check_route(case, dtype, routes, backward=True)
            grads_ref = attention_bwd_plain(p, do, q, k, v)
            torch.cuda.synchronize()
            check(all(torch.isfinite(g).all().item() for g in grads),
                  f"attention backward {case[0]}: non-finite")
            if bwd_route in ("long", "tf32x3_long"):      # the same bits over two calls
                check(all(torch.equal(g, h) for g, h in zip(grads, attention_bwd(p, do, q, k, v))),
                      f"attention backward {case[0]} ({bwd_route}): bits differ between calls")
            out_err = (out.float() - ref.float()).abs().max().item()
            p_err = (p.float() - p_ref.float()).abs().max().item()
            rel = [(g.float() - r.float()).abs().max().item()
                   / (1 + r.float().abs().max().item()) for g, r in zip(grads, grads_ref)]
            note = ""
            if dtype == torch.float32:
                check(out_err <= ATTN_TOL[dtype], f"{case[0]}: forward err {out_err}")
                check(p_err <= P_TOL_F32, f"{case[0]}: saved P err {p_err}")
                check(max(rel) <= BWD_REL_TOL_F32, f"{case[0]}: backward rel err {rel}")
            else:
                shares = [bf16_share(out, ref), bf16_share(p, p_ref)] + [
                    bf16_share(g, r) for g, r in zip(grads, grads_ref)]
                note = ("; >1 ulp share out/P/dQ/dK/dV " + " ".join(
                    f"{sh:.1e}" for sh, _ in shares) + f" (max {max(m for _, m in shares):.1f} ulps)")
                for (sh, _), what in zip(shares, ("out", "P", "dQ", "dK", "dV")):
                    check(sh <= ATTN_BF16_SHARE, f"{case[0]} bf16 {what}: share {sh}")
            fwd = functools.partial(attention_fwd, q, k, v, b2, bb, save_p=True)
            fwd_plain = functools.partial(attention_fwd_plain, q, k, v, b2, bb)
            bwd = functools.partial(attention_bwd, p, do, q, k, v)
            bwd_plain = functools.partial(attention_bwd_plain, p, do, q, k, v)
            times = [call_ms(f, reps=reps) for f in (fwd, fwd_plain, bwd, bwd_plain)]
            two_pass, two_note, bwd_two, bwd_note, two_err, bwd_two_err = None, "", None, "", 0, 0
            if route != "two_pass" and (dtype == torch.bfloat16 or f32_timed(case[0])):
                two_pass, two_note, two_err = two_pass_beside(case, (q, k, v, b2, bb), True, ref,
                                                              p_ref, reps)
            if bwd_route != "two_pass" and (dtype == torch.bfloat16 or f32_timed(case[0])):
                bwd_two, bwd_note, bwd_two_err = bwd_two_pass_beside(case, (p, do, q, k, v),
                                                                     grads_ref, reps)
            print(f"  attention {case[0]:34s} {dname:8s} fwd ({route}) err {out_err:.3e}, P err "
                  f"{p_err:.3e}, bwd ({bwd_route}) rel err dQ/dK/dV "
                  f"{' '.join(f'{r:.2e}' for r in rel)}{note}  fwd {times[0]:.4f} / "
                  f"{times[1]:.4f} ms, bwd {times[2]:.4f} / {times[3]:.4f} ms{two_note}{bwd_note}")
            if case in TRAIN_DP_ATTN_CASES or (case in TRAIN_TP_ATTN_CASES
                                               and case[1] != TRAIN_BATCH) or (
                    case in large_attn and not (case[0] in profiled and dtype == torch.bfloat16)
                    and not (dtype == torch.float32 and f32_timed(case[0]))):
                continue               # checked above; profiled at B = 96, LARGE_PROFILED, F32_TIMED
            _, b, lq, lk, h, bias, _ = case
            timings.append(dict(
                name=f"attention fwd+P {case[0]} {dname}", kernel=fwd, plain=fwd_plain,
                two_pass=two_pass, gate=dtype == torch.bfloat16 or case[0] in F32_GATED,
                work=(*bounds.attention_fwd_work(b, lq, lk, h, dtype, save_p=True,
                                                 bias2d=b2 is not None,
                                                 biasb=bb is not None), dtype),
                library=sdpa_library(q, k, v, b2, bb)))
            if case is TRAIN_ATTN_CASES[0] and dtype == torch.bfloat16:
                summary["attention_fwd_train"] = dict(max_abs_err=out_err,
                                                      timing=len(timings) - 1)
            if case is TRAIN_ATTN_CASES[0] and dtype == torch.float32:
                summary["attention_fwd_tf32x3"] = dict(max_abs_err=out_err, p_err=p_err,
                                                       two_pass_err=two_err,
                                                       timing=len(timings) - 1)
            if case == b32_attn[0] and dtype == torch.bfloat16:
                summary["b32_attention_fwd"] = dict(max_abs_err=out_err,
                                                    timing=len(timings) - 1)
            if case == shapes["448"][0][0] and dtype == torch.bfloat16:   # Lk 784: cluster
                summary["attention_fwd_cluster"] = dict(max_abs_err=out_err,
                                                        two_pass_err=two_err,
                                                        timing=len(timings) - 1)
            timings.append(dict(
                name=f"attention bwd {case[0]} {dname}", kernel=bwd, plain=bwd_plain,
                two_pass=bwd_two, gate=dtype == torch.bfloat16 or case[0] in F32_BWD_GATED,
                work=(*bounds.attention_bwd_work(b, lq, lk, h, dtype), dtype),
                library=sdpa_library(q, k, v, b2, bb, do), pair=len(timings) - 1))
            f32_keys = {TRAIN_ATTN_CASES[0]: "attention_bwd_tf32x3",
                        shapes["448_f32"][0][0]: "attention_bwd_tf32x3_long"}   # Lk 784
            if dtype == torch.float32 and case in f32_keys:
                summary[f32_keys[case]] = dict(
                    max_abs_err=max((g - r).abs().max().item() for g, r in zip(grads, grads_ref)),
                    rel_err=max(rel), two_pass_err=bwd_two_err, timing=len(timings) - 1)
            keys = {TRAIN_ATTN_CASES[0]: "attention_bwd_one_pass", b32_attn[0]: "b32_attention_bwd",
                    shapes["448"][0][0]: "attention_bwd_cluster",   # Lk 784: cluster
                    shapes["672"][0][0]: "attention_bwd_long"}      # Lk 1764: long
            if dtype == torch.bfloat16 and case in keys:
                summary[keys[case]] = dict(max_abs_err=max((g.float() - r.float()).abs().max().item()
                                                           for g, r in zip(grads, grads_ref)),
                                           two_pass_err=bwd_two_err, timing=len(timings) - 1)

        for name, n, g, l, d in GROUP_ST_CASES + large_gumbel:
            if dtype == torch.bfloat16 and name in f32_only:
                continue
            reps = LARGE_REPS if name in {c[0] for c in large_gumbel} else 50
            q = torch.randn(n, g, d, generator=gen, device=dev).to(dtype)
            k = torch.randn(n, l, d, generator=gen, device=dev).to(dtype)
            v = torch.randn(n, l, d, generator=gen, device=dev).to(dtype)
            u = torch.rand(n, g, l, generator=gen, device=dev)
            noise = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
            out, hard, soft, y_soft = group_assign_fwd(q, k, v, noise, TAU)
            _, hard_ref, soft_ref, y_ref = group_assign_st_plain(q, k, v, noise, TAU)
            same = all(torch.equal(a, b) for a, b in zip(
                (out, hard, soft, y_soft), group_assign_fwd(q, k, v, noise, TAU)))
            torch.cuda.synchronize()
            logits = torch.matmul(q.double(), k.double().transpose(1, 2))
            top2 = ((logits + noise.double()) / TAU).topk(2, dim=1).values
            near = (top2[:, 0] - top2[:, 1]) < NEAR_TIE
            differ = (hard != hard_ref).any(dim=1)
            n_near, n_bad = int(near.sum()), int((differ & ~near).sum())
            soft_err = (soft - soft_ref).abs().max().item()
            y_err = (y_soft - y_ref).abs().max().item()
            counts = hard.sum(-1, keepdim=True).clamp(min=1.0)
            out_ref = (torch.matmul(hard, v.float()) / counts).to(dtype)
            out_err = (out.float() - out_ref.float()).abs().max().item()
            if dtype == torch.bfloat16:
                from segclip_tpu_torch.ops.kernels.checks import bf16_ulps
                out_ulps = bf16_ulps(out, out_ref).max().item()
                out_ok, out_note = out_ulps <= 1, f" ({out_ulps:g} ulps)"
            else:
                out_ok, out_note = out_err <= OUT_TOL_F32, ""
            kernel = functools.partial(group_assign_fwd, q, k, v, noise, TAU)
            plain = functools.partial(group_assign_st_plain, q, k, v, noise, TAU)
            print(f"  gumbel grouping {name:28s} {dname:8s} soft err {soft_err:.3e} y_soft "
                  f"err {y_err:.3e} out err {out_err:.3e}{out_note}; hard differs on "
                  f"{int(differ.sum())} patches, {n_near} near-tie patches; run twice "
                  f"bit-identical: {same}  {call_ms(kernel, reps=reps):.4f} / "
                  f"{call_ms(plain, reps=reps):.4f} ms")
            check(same, f"gumbel grouping {name} {dtype}: a second call gave other bits")
            check(n_bad == 0, f"gumbel grouping {name}: hard differs on {n_bad} clear patches")
            check(soft_err <= SOFT_TOL, f"gumbel grouping {name}: soft err {soft_err}")
            check(y_err <= YSOFT_TOL, f"gumbel grouping {name}: y_soft err {y_err}")
            check(out_ok, f"gumbel grouping {name} {dtype}: out err {out_err}{out_note}")
            check(int(hard.sum()) == n * l, f"gumbel grouping {name}: hard is not one-hot")
            if "DP" in name or (reps == LARGE_REPS and not (name in profiled
                                                            and dtype == torch.bfloat16)):
                continue               # checked above; profiled at N = 96 and LARGE_PROFILED
            timings.append(dict(name=f"gumbel grouping {name} {dname}", kernel=kernel,
                                plain=plain, library=None,
                                work=(*bounds.group_assign_work(n, g, l, d, dtype, True),
                                      dtype)))
            keys = {GROUP_ST_CASES[0][0]: "grouping_st", GROUP_ST_CASES[1][0]: "grouping_st_mae",
                    b32_gumbel[0][0]: "b32_grouping_st"}
            if dtype == torch.bfloat16 and name in keys:
                summary[keys[name]] = dict(max_abs_err=out_err, timing=len(timings) - 1)


def repaired_fault(dev) -> None:
    """On CUDA the kernel wrappers' outputs carry gradients: a loss over
    them reaches the inputs, as on the CPU."""
    from segclip_tpu_torch.ops.kernels.attention import attention
    from segclip_tpu_torch.ops.kernels.grouping import group_assign, group_assign_st

    x = torch.randn(2, 9, 3 * 64, device=dev, requires_grad=True)
    out = attention(x[..., :64], x[..., 64:128], x[..., 128:])
    q = torch.randn(2, 8, 64, device=dev, requires_grad=True)
    k = torch.randn(2, 9, 64, device=dev, requires_grad=True)
    grouped = group_assign(q, k, k)
    grouped_st = group_assign_st(q, k, k, torch.zeros(2, 8, 9, device=dev), TAU)
    check(out.requires_grad and all(t.requires_grad for t in grouped + grouped_st),
          "a kernel output on CUDA does not require grad")
    (out.sum() + grouped[0].sum() + grouped[2].sum() + grouped_st[0].sum()).backward()
    check(x.grad.abs().sum().item() > 0 and q.grad.abs().sum().item() > 0,
          "no gradient reached the kernels' inputs")
    print("  repaired fault: attention and grouping outputs require grad on CUDA, and "
          "their gradients reach q, k, v")


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, (time.perf_counter() - t0) * 1e3


def reset_counters() -> None:
    from segclip_tpu_torch.ops.attention import plain_route
    from segclip_tpu_torch.ops.kernels.attention import attention, attention_bwd
    from segclip_tpu_torch.ops.kernels.grouping import group_assign, group_assign_st
    attention.launches = attention_bwd.launches = 0
    group_assign.launches = group_assign_st.launches = 0
    plain_route.calls = 0


ROUTES = ("one_pass", "cluster", "long", "tf32x3", "two_pass")
BWD_ROUTES = ("one_pass", "cluster", "long", "tf32x3", "tf32x3_long", "two_pass")
ROUTE_FUNCTIONS = {"one_pass": "attention_fwd_one_pass", "cluster": "attention_fwd_cluster",
                   "long": "attention_fwd_long", "tf32x3": "attention_fwd_tf32x3",
                   "two_pass": "attention_fwd_two_pass",
                   "bwd_one_pass": "attention_bwd_one_pass",
                   "bwd_cluster": "attention_bwd_cluster",
                   "bwd_long": "attention_bwd_long",
                   "bwd_tf32x3": "attention_bwd_tf32x3",
                   "bwd_tf32x3_long": "attention_bwd_tf32x3_long",
                   "bwd_two_pass": "attention_bwd_two_pass"}


def reset_routes() -> None:
    """Zero the forward's and the backward's route counters (reset_counters
    leaves them, so that they add up over the whole main path)."""
    from segclip_tpu_torch.ops.kernels import attention as kattn
    for fn in ROUTE_FUNCTIONS.values():
        getattr(kattn, fn).launches = 0


def read_routes() -> dict:
    """Launches by route in this process: forward {"one_pass", "cluster",
    "long", "tf32x3", "two_pass"} and backward {"bwd_one_pass", "bwd_cluster",
    "bwd_long", "bwd_tf32x3", "bwd_tf32x3_long", "bwd_two_pass"}."""
    from segclip_tpu_torch.ops.kernels import attention as kattn
    return {key: getattr(kattn, fn).launches for key, fn in ROUTE_FUNCTIONS.items()}


def add_routes(into: dict, more: dict) -> None:
    for key, n in more.items():
        into[key] = into.get(key, 0) + n


# Forward launches by route made in other processes of the main path (phase
# 9's ranks, phase 10's studies), added as their results come back.
ROUTES_ELSEWHERE = {key: 0 for key in ROUTE_FUNCTIONS}


def read_counters() -> dict:
    from segclip_tpu_torch.ops.attention import plain_route
    from segclip_tpu_torch.ops.kernels.attention import attention, attention_bwd
    from segclip_tpu_torch.ops.kernels.grouping import group_assign, group_assign_st
    return {"attention_fwd": attention.launches, "attention_bwd": attention_bwd.launches,
            "group_assign": group_assign.launches,
            "group_assign_st": group_assign_st.launches, "plain_route": plain_route.calls}


def phase_slice(dev, cfg) -> tuple:
    """Phase 2: the zero-shot path at ViT-B/16 width; returns the model, the
    segmenter, its requests and the launch counts of the path."""
    from segclip_tpu_torch.evalseg.inference import ZeroShotSegmenter
    from segclip_tpu_torch.evalseg.text_bank import build_text_bank
    from segclip_tpu_torch.models.segclip import init_segclip
    from segclip_tpu_torch.ops.kernels.attention import attention
    from segclip_tpu_torch.ops.kernels.grouping import group_assign

    model, init_ms = timed(lambda: init_segclip(cfg, seed=0, device=dev))
    print(f"phase 2: ViT-B/16 ({cfg.compute_dtype}) seeded init {init_ms:.0f} ms")
    rng = np.random.default_rng(0)
    img_224 = rng.standard_normal((224, 224, 3), dtype=np.float32)
    img_224x448 = rng.standard_normal((224, 448, 3), dtype=np.float32)
    img_300x500 = rng.standard_normal((224, 373, 3), dtype=np.float32)  # short side 224
    img_224x336 = rng.standard_normal((224, 336, 3), dtype=np.float32)
    img_448x672 = rng.standard_normal((448, 672, 3), dtype=np.float32)
    img_224x2048 = rng.standard_normal((224, 2048, 3), dtype=np.float32)
    num_classes = len(VOC_CLASSES) + 1

    reset_counters()
    bank, bank_ms = timed(lambda: build_text_bank(model, VOC_CLASSES, "simple",
                                                  cfg.context_length))
    check(tuple(bank.shape) == (20, cfg.embed_dim), f"text bank {tuple(bank.shape)}")
    check(attention.launches == 12 and group_assign.launches == 0,
          f"text bank launches: attention {attention.launches}, grouping "
          f"{group_assign.launches}; expected 12, 0")
    print(f"  text bank (20 classes, 1 template): {bank_ms:.1f} ms (cold)")
    seg = ZeroShotSegmenter(model, bank, with_bg=True, bg_thresh=VOC_BG_THRESH,
                            patch_size=cfg.vision_patch_size)

    requests = (
        ("224x224 whole", lambda: seg.predict(img_224, (224, 224), "whole"),
         (224, 224), num_classes),
        ("224x448 slide (2 windows)",
         lambda: seg.predict(img_224x448, (224, 448), "slide"), (224, 448), num_classes),
        ("300x500 slide (224x373, 2 windows)",
         lambda: seg.predict(img_300x500, (300, 500), "slide"), (300, 500), num_classes),
        # 294 patches: the vision and cross blocks' rows (Lk 294, 302) take
        # the cluster kernel
        ("224x336 whole", lambda: seg.predict(img_224x336, (224, 336), "whole"), (224, 336),
         num_classes),
        # 1176 patches: the vision and cross blocks' rows (Lk 1176, 1184) are
        # past CLUSTER_LIMIT and take the long kernel
        ("448x672 whole", lambda: seg.predict(img_448x672, (448, 672), "whole"), (448, 672),
         num_classes),
        # the eval CLIs' widest image (keep_ratio_resize: short side 224, long
        # side at most 2048): 14 × 128 = 1792 patches, rows of 1792 and 1800
        ("224x2048 whole", lambda: seg.predict(img_224x2048, (224, 2048), "whole"), (224, 2048),
         num_classes),
        ("224x224 group_map", lambda: seg.group_map(img_224), (224, 224), cfg.group_num),
    )
    request_routes = {}
    for name, fn, shape, upper in requests:
        before, routes = read_counters(), read_routes()
        pred, cold_ms = timed(fn)
        per_request = {k: n - before[k] for k, n in read_counters().items()}
        request_routes[name] = {k: n - routes[k] for k, n in read_routes().items()}
        da, dg = per_request["attention_fwd"], per_request["group_assign"]
        check(pred.shape == shape and pred.dtype == np.int32,
              f"{name}: {pred.shape} {pred.dtype}")
        check(pred.min() >= 0 and pred.max() < upper, f"{name}: labels out of range")
        check(da == 14 and dg == 1, f"{name}: {da} attention / {dg} grouping "
                                    f"launches, expected 14 / 1")
        print(f"  {name}: cold {cold_ms:.1f} ms, labels {np.unique(pred).size} "
              f"distinct, launches attention {da} grouping {dg}; attention by route "
              f"{request_routes[name]}")
    counts = read_counters()
    check(counts == {"attention_fwd": 12 + len(requests) * 14, "attention_bwd": 0,
                     "group_assign": len(requests), "group_assign_st": 0, "plain_route": 0},
          f"path launch counts {counts}")
    wide = request_routes["224x336 whole"]
    long_rows = cfg.first_stage_layer + cfg.cross_layer      # Lk 294 and 302; the group stage's 8
    check(wide["cluster"] == long_rows and wide["one_pass"] == 14 - long_rows
          and wide["two_pass"] == 0, f"224x336 whole: attention by route {wide}; expected "
          f"{long_rows} (the first stage and cross blocks) on the cluster kernel")
    for name in ("448x672 whole", "224x2048 whole"):
        r = request_routes[name]
        check(r["long"] == long_rows and r["one_pass"] == 14 - long_rows
              and r["cluster"] == r["tf32x3"] == r["two_pass"] == 0, f"{name}: attention by "
              f"route {r}; expected {long_rows} (the first stage and cross blocks) on the long "
              "kernel")

    for name, fn, _, _ in requests:                   # warm latency, uncounted
        warm = sorted(timed(fn)[1] for _ in range(WARM_REQUESTS))
        print(f"  {name}: warm median {warm[WARM_REQUESTS // 2]:.2f} ms (min {warm[0]:.2f}, "
              f"max {warm[-1]:.2f}, {WARM_REQUESTS} runs)")
    for logits in (seg.whole(img_224), seg.slide(img_300x500)):
        check(np.isfinite(logits).all(), "non-finite logits")
    print(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB")
    # the phase's long forwards: the 448x672 and 224x2048 requests', counted
    # once and warm
    return (model, seg, requests, counts, per_request, wide["cluster"],
            2 * long_rows * (1 + WARM_REQUESTS))


def train_path_counts(cfg) -> dict:
    """Launches of one training step, from the configuration: the text
    tower, the grouping path's vision tower (layers0, cross blocks, group
    stage) and, with vision MAE, the masked vision forward (layers0, cross
    blocks, layers_mae2) run the attention kernels forward and backward;
    each SemanticLearner runs the Gumbel grouping once; the MAE decoders'
    blocks take the plain route. With remat, the backward recomputes every
    block of the rematerialised stacks (layers0, layers2, layers_mae2, the
    text blocks, the decoders' blocks; not the cross blocks), which runs
    its attention forward once more."""
    stacks = cfg.transformer_layers + cfg.vision_layers   # layers0 + second stage, text
    attn = stacks + cfg.cross_layer
    plain = 0
    if cfg.use_vision_mae_recon:
        attn += cfg.vision_layers + cfg.cross_layer
        stacks += cfg.vision_layers
        plain += cfg.mae_decoder_depth
    if cfg.use_text_mae_recon:
        attn += cfg.transformer_layers
        stacks += cfg.transformer_layers
        plain += cfg.mae_decoder_depth
    st = 1 + int(cfg.use_vision_mae_recon)
    again = int(cfg.remat)
    return {"attention_fwd": attn + again * stacks, "attention_bwd": attn,
            "group_assign": 0, "group_assign_st": st, "plain_route": (1 + again) * plain}


def large_config(name: str, remat: bool):
    """The ModelConfig of LARGE_CONFIGS[name], with or without remat."""
    from segclip_tpu_torch.config import model_config_for
    arch, overrides, _ = LARGE_CONFIGS[name]
    return model_config_for(arch, remat=remat, **overrides)


def b32_config():
    """The ViT-B/32 preset's ModelConfig."""
    from segclip_tpu_torch.config import model_config_for
    return model_config_for(B32_ARCH)


def l14_f32_config():
    """Phase 12's ViT-L/14 at float32 (the reference's precision), no remat."""
    return dataclasses.replace(large_config("l14", False), compute_dtype="float32")


def drift_fixture(path: str = DRIFT_FIXTURE) -> dict:
    """The recorded trajectory: "cfg" (the port's Config of the JAX run),
    "t_total", "seed", "sd" (the JAX init in the reference layout), "batch",
    "noise" (each of NOISE_KEYS stacked over the steps) and "losses" (JAX's,
    one per step), as CPU tensors."""
    from segclip_tpu_torch.config import Config, ModelConfig, OptimConfig

    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    meta = json.loads(str(data.pop("config")))
    out = {"cfg": Config(model=ModelConfig(**meta["model"]),
                         optim=OptimConfig(**meta["optim"])),
           "t_total": meta["t_total"], "seed": meta["seed"],
           "losses": [float(x) for x in data.pop("losses")]}
    for group in ("sd", "batch", "noise"):
        out[group] = {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in data.items()
                      if k.startswith(group + "/")}
    out["batch"] = {k: v if v.is_floating_point() else v.long()
                    for k, v in out["batch"].items()}
    return out


def drift_replay(dev, fixture: dict) -> dict:
    """The fixture's steps of make_train_step on `dev` from its init, on its
    batch, with its draws injected: each step's loss, skip flag and
    launches, and the first step's kernel shapes."""
    from segclip_tpu_torch.checkpoint.convert import load_into
    from segclip_tpu_torch.models.segclip import SegCLIP
    from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step

    cfg = fixture["cfg"]
    model = SegCLIP(cfg.model)
    check(load_into(model, fixture["sd"]) == [], "the fixture's state dict does not fit")
    model = model.to(dev)
    step = make_train_step(model, create_optimizer(model, cfg, t_total=fixture["t_total"]),
                           cfg)
    state = TrainState(step=0, seed=fixture["seed"])
    batch = {k: v.to(dev) for k, v in fixture["batch"].items()}
    out = {"loss": [], "skipped": [], "counts": []}
    for i in range(len(fixture["losses"])):
        noise = {k: v[i].to(dev) for k, v in fixture["noise"].items()}
        reset_counters()
        with ShapeProbe() as shapes:
            metrics = step(state, batch, noise)
        out["counts"].append(read_counters())
        out["loss"].append(float(metrics["loss"]))
        out["skipped"].append(float(metrics["skipped_nan"]))
        if i == 0:
            out["shapes"] = (shapes.attn, shapes.gumbel)
    return out


def step_shapes(name: str, cfg, b: int) -> tuple:
    """The kernels' shapes in one training step of `cfg` at batch b:
    attention cases (phase 1's form) of the grouping path's vision blocks,
    cross blocks (G centres over G + L) and group stage, the masked
    forward's kept patches (layers0, layers_mae2) and cross blocks, the
    text blocks and, with text MAE, the masked text forward's kept tokens;
    the Gumbel grouping's (N, G, L, D) of both paths."""
    l, g, h, d = cfg.num_patches, cfg.group_num, cfg.vision_heads, cfg.vision_width
    kept = int((l + 1) * (1 - cfg.mae_vis_mask_ratio)) - 1
    t, th = cfg.max_words, cfg.transformer_heads
    attn = ((f"{name} vision {b}x{l} H{h}", b, l, l, h, None, "self"),
            (f"{name} cross {b}x{g}x{g + l} H{h}", b, g, g + l, h, None, "cross"),
            (f"{name} group stage {b}x{g}x{g} H{h}", b, g, g, h, None, "self"),
            (f"{name} MAE vision {b}x{kept} H{h}", b, kept, kept, h, None, "self"),
            (f"{name} MAE cross {b}x{g}x{g + kept} H{h}", b, g, g + kept, h, None, "cross"),
            (f"{name} text {b}x{t} causal H{th}", b, t, t, th, "causal", "self"))
    if cfg.use_text_mae_recon:
        kt = int(t * (1 - cfg.mae_seq_mask_ratio))
        attn += ((f"{name} text MAE {b}x{kt} causal H{th}", b, kt, kt, th, "causal", "self"),)
    gumbel = ((f"{name} {b}x{g}x{l}x{d}", b, g, l, d),
              (f"{name} MAE {b}x{g}x{kept}x{d}", b, g, kept, d))
    return attn, gumbel


def synthetic_batch(b: int, cfg, seed: int, device) -> dict:
    """uint8 images, (B, 14, 14) superpixel ids and 32-token captions (BOS,
    3-20 words, EOT, zero padding), from numpy."""
    rng = np.random.default_rng(seed)
    res, grid, length = cfg.image_resolution, cfg.grid_size, cfg.max_words
    ids = np.zeros((b, length), np.int64)
    for i, n in enumerate(rng.integers(3, min(21, length - 1), size=b)):
        ids[i, 0] = cfg.vocab_size - 2                      # BOS
        ids[i, 1:n + 1] = rng.integers(1, cfg.vocab_size - 2, size=n)
        ids[i, n + 1] = cfg.vocab_size - 1                  # EOT, the row's max id
    batch = {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int64),
             "image": rng.integers(0, 256, size=(b, res, res, 3), dtype=np.uint8),
             "image_seg": rng.integers(0, 12, size=(b, grid, grid))}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def phase_train(dev) -> tuple:
    """Phase 4: the training step at ViT-B/16 width, B = 96."""
    from segclip_tpu_torch.config import Config
    from segclip_tpu_torch.models.segclip import init_segclip
    from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step

    cfg = Config()
    mcfg = cfg.model
    model = init_segclip(mcfg, seed=0, device=dev)
    optimizer = create_optimizer(model, cfg, t_total=100)
    step = make_train_step(model, optimizer, cfg)
    state = TrainState(step=0, seed=0)
    batch = synthetic_batch(TRAIN_BATCH, mcfg, 0, dev)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    expected = train_path_counts(mcfg)
    print(f"phase 4: training step, ViT-B/16 ({mcfg.compute_dtype}), B={TRAIN_BATCH}, "
          f"{len(frozen)} frozen parameter tensors; expected launches per step {expected}")
    torch.cuda.reset_peak_memory_stats(dev)
    totals, times = {}, []
    for i in range(1 + TRAIN_STEPS):
        reset_counters()
        routes = read_routes()
        metrics, ms = timed(lambda: step(state, batch))
        counts = read_counters()
        routes = {k: n - routes[k] for k, n in read_routes().items()}
        check(counts == expected, f"step {i}: launches {counts}, expected {expected}")
        check(routes == {"one_pass": expected["attention_fwd"], "cluster": 0, "long": 0,
                         "tf32x3": 0, "two_pass": 0, "bwd_one_pass": expected["attention_bwd"],
                         "bwd_cluster": 0, "bwd_long": 0, "bwd_tf32x3": 0,
                         "bwd_tf32x3_long": 0, "bwd_two_pass": 0},
              f"step {i}: launches by route {routes}, expected every one of the "
              f"{expected['attention_fwd']} forwards and {expected['attention_bwd']} backwards "
              "on the one-pass kernels")
        for key, n in counts.items():
            totals[key] = totals.get(key, 0) + n
        values = {k: float(v) for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in values.values()), f"step {i}: {values}")
        check(values["skipped_nan"] == 0.0, f"step {i} was skipped")
        times.append(ms)
        print(f"  step {i} ({'cold' if i == 0 else 'warm'}): {ms:.1f} ms; " + ", ".join(
            f"{k} {v:.5f}" for k, v in values.items()) + f"; launches by route {routes}")
    warm = sorted(times[1:])
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    print(f"  warm step time: median {statistics.median(warm):.2f} ms (min {warm[0]:.2f}, "
          f"max {warm[-1]:.2f}, {len(warm)} steps); "
          f"{TRAIN_BATCH * 1000 / statistics.median(warm):.1f} img/s; "
          f"peak device memory {peak:.0f} MiB")
    moved_not = [n for n, p in model.named_parameters()
                 if p.requires_grad and torch.equal(p, before[n])]
    changed_frozen = [n for n in frozen if not torch.equal(dict(model.named_parameters())[n],
                                                           before[n])]
    check(not changed_frozen, f"frozen parameters changed: {changed_frozen[:5]}")
    check(not moved_not, f"trainable parameters that did not move: {moved_not[:5]}")
    check(state.step == 1 + TRAIN_STEPS and optimizer.step_count == 1 + TRAIN_STEPS,
          f"steps: state {state.step}, optimizer {optimizer.step_count}")
    print(f"  {len(frozen)} frozen tensors bit-identical, every trainable tensor moved; "
          f"launches over {1 + TRAIN_STEPS} steps {totals}")
    return model, step, state, batch, totals, statistics.median(warm), peak


class GroupingProbe:
    """Records, for each SemanticLearner call, the hard assignment and the
    margin between the two largest noised logits of every patch."""

    def __init__(self, learner, noises):
        self.noises, self.records = list(noises), []
        self.handle = learner.register_forward_hook(self.hook)
        self.learner = learner

    def hook(self, module, args, output):
        x, noise = args[0], self.noises[len(self.records)]
        with torch.no_grad():
            k = module.k_ln(module.k_conv(module.norm(x)))
            logits = torch.matmul(output[3].double(), k.double().transpose(1, 2))
            top2 = ((logits + noise.double()) / module.tau).topk(2, dim=1).values
        self.records.append((output[1].detach().cpu(), (top2[:, 0] - top2[:, 1]).cpu()))


def phase_train_plain_self(dev, model, mcfg=None, phase: int = 5, remat: bool = True) -> None:
    """Phase 5: one float32 training step at full width, B = 2, with the
    same injected noise on the card and on the CPU; and (phase 12) the
    card's step with remat against the same CPU step. Phase 13 runs it at
    ViT-B/32 (`mcfg`, `model` of that config) without the remat step."""
    from segclip_tpu_torch.config import Config, ModelConfig
    from segclip_tpu_torch.models.segclip import SegCLIP
    from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step

    mcfg = dataclasses.replace(mcfg or ModelConfig(), compute_dtype="float32")
    b, g, l = 2, mcfg.group_num, mcfg.num_patches
    kept = int((l + 1) * (1 - mcfg.mae_vis_mask_ratio)) - 1
    rng = np.random.default_rng(5)
    noise = {"gumbel": rng.gumbel(size=(b, g, l)), "gumbel_mae": rng.gumbel(size=(b, g, kept)),
             "mask_vis": rng.random((b, l + 1))}
    noise = {k: torch.from_numpy(v.astype(np.float32)) for k, v in noise.items()}
    batch = synthetic_batch(b, mcfg, 1, "cpu")
    runs = []
    variants = ((dev, False), (dev, True)) if remat else ((dev, False),)
    for device, remat in variants + ((torch.device("cpu"), False),):
        cfg = Config(model=dataclasses.replace(mcfg, remat=remat))
        m = SegCLIP(cfg.model)
        m.load_state_dict(model.state_dict())
        m = m.to(device)
        step = make_train_step(m, create_optimizer(m, cfg, t_total=100), cfg)
        probe = GroupingProbe(m.clip.visual.transformer.semantic_layer2,
                              [noise["gumbel"].to(device), noise["gumbel_mae"].to(device)])
        kernels_before = {k: v for k, v in read_counters().items() if k != "plain_route"}
        metrics = step(TrainState(), {k: v.to(device) for k, v in batch.items()},
                       {k: v.to(device) for k, v in noise.items()})
        probe.handle.remove()
        moved = {k: v for k, v in read_counters().items() if k != "plain_route"} \
            != kernels_before
        check(moved == (device.type == "cuda"),
              f"{device}: kernel launches {'' if moved else 'not '}counted")
        runs.append((float(metrics["loss"]), probe.records,
                     {n: p.grad.detach().cpu() for n, p in m.named_parameters()
                      if p.grad is not None}))
    loss_cpu, rec_cpu, grads_cpu = runs[-1]
    for (loss_gpu, rec_gpu, grads_gpu), what in zip(runs[:-1], ("card", "card with remat")):
        rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
        n_near = n_bad = 0
        for (hard_gpu, _), (hard_cpu, margin) in zip(rec_gpu, rec_cpu):
            near = margin < NEAR_TIE
            differ = (hard_gpu != hard_cpu).any(dim=1)
            n_near += int(near.sum())
            n_bad += int((differ & ~near).sum())
        print(f"phase {phase if what == 'card' else 12}: float32 training step, B=2, {what} vs "
              f"CPU: loss {loss_gpu:.7f} / {loss_cpu:.7f} (rel {rel:.2e}); hard assignments "
              f"differ on {n_bad} clear patches, {n_near} near-tie patches (margin < "
              f"{NEAR_TIE:g})")
        check(np.isfinite(loss_gpu) and rel <= TRAIN_LOSS_RTOL, f"{what}: loss rel err {rel}")
        check(n_bad == 0, f"{what}: hard assignments differ on {n_bad} clear patches")
        check(grads_gpu.keys() == grads_cpu.keys(), "different parameters got gradients")
        if n_near:
            print(f"  near-tie patches present: gradients not compared")
            continue
        worst = max(((grads_gpu[n] - grads_cpu[n]).abs().max().item()
                     / (1 + grads_cpu[n].abs().max().item()), n) for n in grads_cpu)
        print(f"  no near-tie patch: gradients compared on {len(grads_cpu)} tensors, worst "
              f"{worst[0]:.2e}·(1 + max|g|) at {worst[1]} (tol {TRAIN_GRAD_TOL:g})")
        check(worst[0] <= TRAIN_GRAD_TOL, f"{what}: gradient of {worst[1]} off by {worst[0]}")


def counter_delta(before: dict) -> dict:
    return {k: n - before[k] for k, n in read_counters().items()}


class CountingPath:
    """Records the launch counters' change over each training step the loop
    runs and over each eval request, by wrapping `train.loop.make_train_step`
    and `ZeroShotSegmenter.predict` for the length of a `with` block."""

    def __init__(self):
        self.steps, self.requests = [], []

    def __enter__(self):
        from segclip_tpu_torch.evalseg.inference import ZeroShotSegmenter
        from segclip_tpu_torch.train import loop
        self.make, self.predict = loop.make_train_step, ZeroShotSegmenter.predict
        probe = self

        def make_train_step(*args, **kw):
            step = probe.make(*args, **kw)

            def counted(state, batch, noise=None):
                before = read_counters()
                metrics = step(state, batch, noise)
                probe.steps.append(counter_delta(before))
                return metrics
            return counted

        def predict(segmenter, *args, **kw):
            before = read_counters()
            out = probe.predict(segmenter, *args, **kw)
            probe.requests.append(counter_delta(before))
            return out

        loop.make_train_step, ZeroShotSegmenter.predict = make_train_step, predict
        return self

    def __exit__(self, *exc):
        from segclip_tpu_torch.evalseg.inference import ZeroShotSegmenter
        from segclip_tpu_torch.train import loop
        loop.make_train_step, ZeroShotSegmenter.predict = self.make, self.predict


def read_metrics(out: str) -> list:
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def loader_rate(data: str, transport: str) -> tuple:
    """(batches of TRAIN_BATCH per second of BatchLoader.epoch alone over
    LOADER_EPOCHS epochs, seconds of the cold epoch before them that spawns
    the workers, the cold epoch's first batch), with LOADER_WORKERS spawned
    workers, the phase-6 corpus and dataset settings and `transport`."""
    from segclip_tpu_torch.config import DataConfig
    from segclip_tpu_torch.data.pipeline import BatchLoader, ShardedEpochSampler, build_dataset

    factory = functools.partial(build_dataset, DataConfig(
        datatype="shapes", data_dir=data, batch_size=TRAIN_BATCH, **TRANSPORTS[transport]),
        use_seg=True, normalize=False)
    dataset = factory()
    sampler = ShardedEpochSampler(len(dataset), TRAIN_BATCH, seed=42)
    loader = BatchLoader(dataset, sampler, seed=42, num_workers=LOADER_WORKERS,
                         dataset_factory=factory)
    try:
        t0 = time.perf_counter()
        cold = list(loader.epoch(0))
        check(len(cold) == sampler.steps, f"loader ({transport}): short cold epoch")
        t1 = time.perf_counter()
        n = sum(1 for epoch in range(1, 1 + LOADER_EPOCHS) for _ in loader.epoch(epoch))
        return n / (time.perf_counter() - t1), t1 - t0, cold[0]
    finally:
        loader.close()


def log_step_times(out: str) -> list:
    with open(os.path.join(out, "log.txt")) as f:
        return [float(t) for t in re.findall(r"Time/step ([0-9.]+)", f.read())]


def eval_request_counts(cfg) -> dict:
    """Launches of one zero-shot eval request of one crop: the vision and
    cross blocks' attention forward, one eval grouping."""
    return {"attention_fwd": cfg.vision_layers + cfg.cross_layer, "attention_bwd": 0,
            "group_assign": 1, "group_assign_st": 0, "plain_route": 0}


def check_cli_launches(name: str, cfg, path, counts: dict, evals: int) -> None:
    """A `cli.train` run's launches: each step's equal to the path's count,
    each eval request's, and outside them the `evals` text banks'
    attention only."""
    expected_step, expected_request = train_path_counts(cfg), eval_request_counts(cfg)
    check(all(c == expected_step for c in path.steps),
          f"{name}: launches per step {path.steps}, expected {expected_step}")
    check(len(path.requests) == evals * CORPUS_EVAL_N
          and all(c == expected_request for c in path.requests),
          f"{name}: launches per eval request {path.requests}, expected {expected_request}")
    text_banks = {k: counts[k] - sum(c[k] for c in path.steps + path.requests)
                  for k in counts}
    check(text_banks == {**{k: 0 for k in counts},
                         "attention_fwd": evals * cfg.transformer_layers},
          f"{name}: launches outside the steps and requests {text_banks}: expected the "
          f"{evals} text banks' attention only")


def phase_train_cli(smi: str, warm_step_ms: float, tmp: str) -> tuple:
    """Phase 6: pretraining through the CLI from SGR records made on the
    machine (into <tmp>/shapes, kept for phases 7-10), at ViT-B/16 width in
    bf16 (the preset's B = 96), per-epoch eval on the card, keep_best: run A
    on the default transport (yuv420) and a resume that must reproduce its
    last epoch; run C on device_aug in two epochs_per_run segments; the
    loader alone in each transport. Returns the launch counts of run A and
    of run C, and the first batch of each transport (for phase 11)."""
    from segclip_tpu_torch.cli import prepare_data
    from segclip_tpu_torch.cli import train as train_cli
    from segclip_tpu_torch.config import ModelConfig

    cfg = ModelConfig()
    t_phase = time.perf_counter()
    data, run_a, run_b, run_c = (os.path.join(tmp, d) for d in ("shapes", "a", "b", "c"))
    print(f"phase 6: pretraining through the CLI from SGR records ({smi}); "
          f"{shutil.disk_usage(tmp).free / 2**30:.0f} GiB free in {tmp}")
    t0 = time.perf_counter()
    prepare_data.main(["shapes", "--out-dir", data, "--train-n", str(CORPUS_TRAIN_N),
                       "--eval-n", str(CORPUS_EVAL_N)])
    prep_s = time.perf_counter() - t0
    argv = ["--preset", "shapes-learnability", "--data-dir", data, "--epochs", "2",
            "--num-workers", str(LOADER_WORKERS), "--n-display", "1"]

    with CountingPath() as path:
        reset_counters()
        t0 = time.perf_counter()
        result_a = train_cli.main(argv + ["--output-dir", run_a])
        run_a_s = time.perf_counter() - t0
        counts = read_counters()
    metrics_a = read_metrics(run_a)
    losses_a = [m["loss"] for m in metrics_a if "loss" in m]
    mious = [m["miou"] for m in metrics_a if "miou" in m]
    step_times = {"A (yuv420)": log_step_times(run_a)}
    print(f"  prepare_data shapes --train-n {CORPUS_TRAIN_N} --eval-n {CORPUS_EVAL_N}: "
          f"{prep_s:.2f} s; run A (yuv420, the CLI's default; 2 epochs, 4 steps, 2 evals, "
          f"{len(result_a['checkpoints'])} epoch checkpoints + best): {run_a_s:.1f} s")
    print(f"  run A losses {' '.join(f'{v:.5f}' for v in losses_a)}; mIoU per epoch "
          f"{' '.join(f'{v:.2f}' for v in mious)}; launches per step {path.steps}")
    check(len(losses_a) == 4 and all(np.isfinite(losses_a)), f"run A losses {losses_a}")
    check(len(mious) == 2 and all(np.isfinite(mious)), f"run A mIoU lines {mious}")
    for name in ("ckpt_epoch_0", "ckpt_epoch_1", "ckpt_best", "best.json"):
        check(os.path.exists(os.path.join(run_a, name)), f"run A wrote no {name}")
    check(len(path.steps) == 4, f"run A ran {len(path.steps)} steps")
    check_cli_launches("run A", cfg, path, counts, 2)

    # The resumed run decodes in the loop's own thread (--num-workers 0):
    # the pipeline's batches are the same bits for any worker count, and
    # it spares a second spawn of four workers.
    shutil.copytree(os.path.join(run_a, "ckpt_epoch_0"), os.path.join(run_b, "ckpt_epoch_0"))
    t0 = time.perf_counter()
    result_b = train_cli.main(argv + ["--output-dir", run_b, "--do-resume",
                                      "--num-workers", "0"])
    run_b_s = time.perf_counter() - t0
    metrics_b = [m for m in read_metrics(run_b) if "loss" in m]
    check(result_b["epochs_run"] == 1 and [m["epoch"] for m in metrics_b] == [1, 1],
          f"the resumed run trained {result_b['epochs_run']} epochs: {metrics_b}")
    a = torch.load(os.path.join(run_a, "ckpt_epoch_1", "model.pt"), weights_only=True)
    b = torch.load(os.path.join(run_b, "ckpt_epoch_1", "model.pt"), weights_only=True)
    check(a.keys() == b.keys(), "resumed model.pt has other keys")
    same = all(torch.equal(a[k], b[k]) for k in a) and metrics_b[-1]["loss"] == losses_a[-1]
    worst = max((a[k].float() - b[k].float()).abs().max().item() for k in a)
    loss_rel = abs(metrics_b[-1]["loss"] - losses_a[-1]) / abs(losses_a[-1])
    print(f"  resume from ckpt_epoch_0 ({run_b_s:.1f} s) trained epoch 1 only; last loss "
          f"{metrics_b[-1]['loss']!r}"
          f" against run A's {losses_a[-1]!r}; model.pt bit-identical: {same} (max "
          f"|Δparam| {worst:.3e}, loss rel {loss_rel:.3e})")
    check(same or (worst <= RESUME_PARAM_TOL and loss_rel <= RESUME_LOSS_RTOL),
          f"resume differs from run A: |Δparam| {worst}, loss rel {loss_rel}")
    del result_a, result_b, a, b
    shutil.copy(os.path.join(run_a, "ckpt_best", "model.pt"), os.path.join(tmp, STUDY_CKPT))
    shutil.rmtree(run_a)
    shutil.rmtree(run_b)
    torch.cuda.empty_cache()

    # Run C: device_aug (the canvas crop-resized in the step) in segments of
    # one epoch; the second segment resumes from the first's checkpoint.
    argv_c = argv + ["--output-dir", run_c, "--opts", "data.device_aug=true",
                     "train.epochs_per_run=1"]
    with CountingPath() as path_c:
        reset_counters()
        segments = []
        for extra in ([], ["--do-resume"]):
            t0 = time.perf_counter()
            result = train_cli.main(argv_c + extra)
            segments.append((result["epochs_run"], time.perf_counter() - t0,
                             sorted(d for d in os.listdir(run_c) if d != "log.txt")))
            del result
            torch.cuda.empty_cache()
        counts_c = read_counters()
    metrics_c = read_metrics(run_c)
    losses_c = [m["loss"] for m in metrics_c if "loss" in m]
    step_times["C (device_aug)"] = log_step_times(run_c)
    print(f"  run C (device_aug, train.epochs_per_run=1, twice, the second with --do-resume): "
          f"segments {[(n, round(s, 1)) for n, s, _ in segments]} (epochs, s); what each left "
          f"{[d for _, _, d in segments]}; losses {' '.join(f'{v:.5f}' for v in losses_c)}; "
          f"mIoU per epoch {[round(m['miou'], 2) for m in metrics_c if 'miou' in m]}; "
          f"launches per step {path_c.steps}")
    check([n for n, _, _ in segments] == [1, 1], f"run C segments {segments}")
    check(segments[0][2] == ["best.json", "ckpt_best", "ckpt_epoch_0", "metrics.jsonl"]
          and segments[1][2] == ["best.json", "ckpt_best", "ckpt_epoch_0", "ckpt_epoch_1",
                                 "metrics.jsonl"], f"run C wrote {segments}")
    check([m["epoch"] for m in metrics_c if "loss" in m] == [0, 0, 1, 1]
          and all(np.isfinite(losses_c)), f"run C trained {metrics_c}")
    check([m["epoch"] for m in metrics_c if "miou" in m] == [0, 1], f"run C evals {metrics_c}")
    check(len(path_c.steps) == 4, f"run C ran {len(path_c.steps)} steps")
    check_cli_launches("run C", cfg, path_c, counts_c, 2)
    shutil.rmtree(run_c)
    torch.cuda.empty_cache()

    rates, batches = {}, {}
    for transport in TRANSPORTS:
        *rates[transport], batches[transport] = loader_rate(data, transport)
    print(f"  the input pipeline against the card ({smi}): the loop's Time/step (ms; steps 1 "
          f"and 3 open an epoch) " + "; ".join(
              f"run {k} {' '.join(f'{t * 1e3:.1f}' for t in v)}" for k, v in step_times.items())
          + f"; phase 4's warm synthetic step {warm_step_ms:.2f} ms, the step alone "
          f"{1e3 / warm_step_ms:.2f} steps/s ({TRAIN_BATCH * 1e3 / warm_step_ms:.0f} img/s)")
    for transport, (rate, cold) in rates.items():
        print(f"  the loader alone, {transport}, {LOADER_WORKERS} workers: a cold epoch (spawn, "
              f"then 2 batches) {cold:.2f} s, then {rate:.2f} batches of {TRAIN_BATCH}/s "
              f"({rate * TRAIN_BATCH:.0f} img/s; {LOADER_EPOCHS} epochs of 2 batches)")
    print(f"  phase 6 took {time.perf_counter() - t_phase:.1f} s")
    return counts, counts_c, batches


def print_profile(name: str, fn) -> None:
    box = {}
    rows = device_rows(lambda: box.__setitem__("wall", timed(fn)[1]))
    if not rows:
        print(f"  {name}, profiled: the profiler saw no device time in {PROFILE_TRIES} "
              f"runs (wall {box['wall']:.2f} ms)")
        return
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"  {name}, profiled: wall {box['wall']:.2f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / box['wall']:.3f}; top:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x  {e.key[:80]}")
    from segclip_tpu_torch.kernels.build import port_kernel_name
    ours = [(port_kernel_name(e.key), e) for e in rows if port_kernel_name(e.key)]
    print(f"    the port's kernels, {sum(e.self_device_time_total for _, e in ours) / 1e3:.3f} "
          "ms in all: " + "; ".join(
              f"{name} {e.self_device_time_total / 1e3:.3f} ms {e.count}x"
              for name, e in sorted(ours, key=lambda x: -x[1].self_device_time_total)))


def routes_in_turns(t: dict, bound: float) -> tuple:
    """The routed kernel's (one-pass or cluster) and the two-pass kernel's
    device ms per call at one shape: each measured ROUTE_ROUNDS times
    (kernel_ms), the two in turns, and the median of each. One profile that
    reads slow (a stray record, a clock still rising) then decides nothing;
    every round is printed where the rounds of one kernel differ by more
    than a fifth."""
    rounds = {"routed": [], "two-pass": []}
    for _ in range(ROUTE_ROUNDS):
        rounds["routed"].append(kernel_ms(t["name"], t["kernel"], bound, t["work"][0]))
        rounds["two-pass"].append(kernel_ms(t["name"] + " (two-pass)", t["two_pass"], bound,
                                            t["work"][0]))
    for route, times in rounds.items():
        if max(times) > 1.2 * min(times):
            print(f"  ({t['name']}, {route}: rounds {' '.join(f'{x:.4f}' for x in times)} ms; "
                  "the median is kept)")
    return statistics.median(rounds["routed"]), statistics.median(rounds["two-pass"])


def kernel_ms(name: str, fn, bound: float, nbytes: float) -> float:
    """A kernel's device ms per call (device_ms). A time under its bound is
    a lost profiler record, so it is measured again, PROFILE_TRIES times at
    most; if every try reads under the bound, the phase fails, unless the
    work's bytes fit in the L2 cache: then the inputs may sit there from the
    call before and the HBM bound does not bind, which is printed."""
    for _ in range(PROFILE_TRIES):
        ms = device_ms(fn)[0]
        if ms >= bound:
            return ms
        print(f"  ({name}: {ms:.4f} ms reads under its bound {bound:.4f}: measured again)")
    check(nbytes <= L2_BYTES, f"{name}: {ms:.4f} ms under its bound {bound:.4f} in "
          f"{PROFILE_TRIES} profiles")
    print(f"  ({name}: {nbytes / 1e6:.1f} MB of work fits the {L2_BYTES / 1e6:.0f} MB L2; "
          "its inputs stay there between calls and the HBM bound does not bind)")
    return ms


def phase_device_time(seg, requests, timings, train_step, large_step, b32_step,
                      px448_step) -> list:
    """Device time from torch.profiler, last: profiling slows the launches
    that follow it, so nothing is timed by the host clock after this. For
    each timing: the kernel's and the plain version's ms per call, the
    library call's (attention only) with its backend, and the bound."""
    from segclip_tpu_torch.ops.kernels.bounds import bound_ms
    print("device time (torch.profiler; ms per call: kernel / plain / library "
          "[SDPA backend]; bound from bounds.py at 3.35 TB/s, 989 TFLOP/s bf16, "
          "495/3 TFLOP/s f32 (three TF32 products per fp32-accurate product); the bwd "
          "rows' library is SDPA forward + backward, set against the kernels' fwd+P + bwd "
          "pair; float32 library rows with TF32 off)")
    rows = []
    for t in timings:
        row = dict(plain_ms=device_ms(t["plain"])[0], library_ms=None, library_backend=None,
                   two_pass_ms=None)
        row["bound_ms"], row["bound_by"] = bound_ms(*t["work"])
        if t.get("two_pass") is None:
            row["ms"] = kernel_ms(t["name"], t["kernel"], row["bound_ms"], t["work"][0])
        else:
            row["ms"], row["two_pass_ms"] = routes_in_turns(t, row["bound_ms"])
        if t["library"] is not None:
            row["library_ms"], top = device_ms(t["library"])
            row["library_backend"] = sdpa_backend(top)
        lib = ("none" if row["library_ms"] is None else
               f"{row['library_ms']:.4f} [{row['library_backend']}]")
        pair = ""
        if "pair" in t:
            row["pair_ms"] = rows[t["pair"]]["ms"] + row["ms"]
            pair = f"; fwd+P + bwd pair {row['pair_ms']:.4f}"
        two = ("" if row["two_pass_ms"] is None else
               f"; two-pass {row['two_pass_ms']:.4f} ({row['two_pass_ms'] / row['ms']:.2f}x)")
        print(f"  {t['name']:58s} {row['ms']:.4f} / {row['plain_ms']:.4f} / {lib}; "
              f"bound {row['bound_ms']:.4f} ({row['bound_by']}), kernel at "
              f"{row['bound_ms'] / row['ms']:.1%} of it{pair}{two}")
        if row["two_pass_ms"] is not None and t.get("gate", True):
            check(row["ms"] < row["two_pass_ms"], f"{t['name']}: the routed kernel "
                  f"({row['ms']:.4f} ms) is not faster than the two-pass ({row['two_pass_ms']:.4f})")
        rows.append(row)
    for name, fn, _, _ in requests[:3]:
        print_profile(name, fn)
    print_profile(f"training step B={TRAIN_BATCH}", train_step)
    print_profile("training step B=512 with remat (phase 12)", large_step)
    print_profile(f"training step ViT-B/32 B={TRAIN_BATCH} (phase 13)", b32_step)
    print_profile(f"training step 448 px B={LARGE_CONFIGS['448'][2]} (phase 12)", px448_step)
    return rows


def kernel_name(mangled: str) -> str:
    """`attention_fwd_bf16_kernel` (or `group_assign_kernel<bf16, true>`)
    from a mangled name: the last length-prefixed identifier that ends in
    `_kernel`, with its element type and bool template arguments."""
    names, i = [], 0
    while i < len(mangled):
        digits = re.match(r"\d+", mangled[i:])
        if digits:
            start = i + len(digits.group())
            names.append(mangled[start:start + int(digits.group())])
            i = start + int(digits.group())
        else:
            i += 1
    kernels = [n for n in names if n.endswith("_kernel")]
    name = kernels[-1] if kernels else mangled
    args = ["bf16"] if "__nv_bfloat16" in names else (
        ["float"] if re.search(r"If[EL]", mangled) else [])
    args += ["true" if flag == "1" else "false" for flag in re.findall(r"Lb([01])E", mangled)]
    args += re.findall(r"Li(\d+)E", mangled)
    return f"{name}<{', '.join(args)}>" if args else name


def print_ptxas(log: str) -> dict:
    """One line per kernel: registers, shared memory and spills (ptxas -v).
    Returns each kernel's spill bytes (stores + loads)."""
    name, notes, spilled = None, [], {}
    for line in log.splitlines() + ["Compiling entry function 'end'"]:
        if "Compiling entry function" in line:
            if name:
                print(f"  ptxas: {kernel_name(name):34s} " + "; ".join(notes))
            name, notes = line.split("'")[1], []
        elif name and ("Used " in line or "spill" in line):
            notes.append(line.split(":", 1)[-1].strip())
            found = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            if found:
                spilled[kernel_name(name)] = spilled.get(kernel_name(name), 0) + sum(map(int, found))
    return spilled


def tensor_core_counts(library) -> dict:
    """Where cuobjdump exists: the tensor-core (HMMA, HGMMA) and TMA
    (UTMALDG, UTMASTG, UBLKCP) instructions in each kernel's SASS, printed;
    the bf16 attention kernels and the bf16 grouping kernel's 16-byte path
    must have tensor-core instructions, and every instance of the one-pass
    and the cluster kernels and of the float32 TF32x3 kernels, forward and
    backward, of the bf16 long forward and of both long backwards' row and
    slab passes HGMMA and TMA ones.
    Returns the tensor-core instructions of each kernel of the kernels JSON
    line, by its name there (empty without cuobjdump)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("  cuobjdump not found: tensor-core and TMA instructions not counted")
        return {}
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, tma, name = {}, {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = kernel_name(found.group(1))
            counts[name], tma[name] = 0, 0
        elif name and re.search(r"\bHMMA\b|\bHGMMA\b", line):
            counts[name] += 1
        elif name and re.search(r"\bUTMALDG\b|\bUTMASTG\b|\bUBLKCP\b", line):
            tma[name] += 1
    print("  SASS tensor-core instructions (HMMA/HGMMA) per kernel: " + ", ".join(
        f"{k} {v}" for k, v in sorted(counts.items())))
    print("  SASS TMA instructions (UTMALDG/UTMASTG/UBLKCP) per kernel: " + ", ".join(
        f"{k} {v}" for k, v in sorted(tma.items()) if v))
    group = "group_assign_kernel<bf16, true>"
    for kernel in ("attention_fwd_bf16_kernel", "attention_bwd_dq_bf16_kernel",
                   "attention_bwd_dkv_bf16_kernel", group):
        check(counts.get(kernel, 0) > 0, f"{kernel}: no tensor-core instruction in its SASS")
    hopper = {}
    for prefix, instances in (("attention_fwd_one_pass_kernel", 4),
                              ("attention_bwd_one_pass_kernel", 4),
                              ("attention_fwd_cluster_kernel", 3),
                              ("attention_bwd_cluster_kernel", 1),
                              ("attention_fwd_tf32x3_kernel", 4),
                              ("attention_fwd_long_kernel", 2),
                              ("attention_bwd_tf32x3_kernel", 1),
                              ("attention_bwd_long_rows_kernel", 2),
                              ("attention_bwd_long_cols_kernel", 1),
                              ("attention_bwd_tf32x3_long_rows_kernel", 1),
                              ("attention_bwd_tf32x3_long_cols_kernel", 1)):
        hopper[prefix] = [k for k in counts if k.startswith(prefix)]
        check(len(hopper[prefix]) == instances, f"{prefix} instances in the SASS: {hopper[prefix]}")
        for kernel in hopper[prefix]:
            check(counts[kernel] > 0 and tma[kernel] > 0, f"{kernel}: {counts[kernel]} HGMMA "
                  f"and {tma[kernel]} TMA instructions in its SASS")
    return {"attention_fwd": sum(counts[k] for k in hopper["attention_fwd_cluster_kernel"]),
            "attention_fwd_long": sum(counts[k] for k in hopper["attention_fwd_long_kernel"]),
            "attention_fwd_one_pass": sum(
                counts[k] for k in hopper["attention_fwd_one_pass_kernel"]),
            "attention_fwd_tf32x3": sum(counts[k] for k in hopper["attention_fwd_tf32x3_kernel"]),
            "attention_bwd": sum(counts[k] for k in hopper["attention_bwd_cluster_kernel"]),
            "attention_bwd_tf32x3": sum(counts[k] for k in hopper["attention_bwd_tf32x3_kernel"]),
            "attention_bwd_long": sum(counts[k] for p in ("attention_bwd_long_rows_kernel",
                                                          "attention_bwd_long_cols_kernel")
                                      for k in hopper[p]),
            "attention_bwd_tf32x3_long": sum(
                counts[k] for p in ("attention_bwd_tf32x3_long_rows_kernel",
                                    "attention_bwd_tf32x3_long_cols_kernel") for k in hopper[p]),
            "attention_bwd_one_pass": sum(
                counts[k] for k in hopper["attention_bwd_one_pass_kernel"]),
            "group_assign": counts[group], "group_assign_st": counts[group]}


def phase_plain_self(dev, model, cfg) -> None:
    """Phase 3: float32 whole requests on the card and on the CPU: 224x224,
    and 448x672, whose 1176 patches' rows (1176, 1184 keys) take the TF32x3
    kernel past 1024 keys on the card (its forwards' routes checked)."""
    from segclip_tpu_torch.evalseg.inference import ZeroShotSegmenter
    from segclip_tpu_torch.evalseg.text_bank import build_text_bank
    from segclip_tpu_torch.models.segclip import SegCLIP
    from segclip_tpu_torch.ops.kernels.attention import attention
    from segclip_tpu_torch.ops.kernels.grouping import group_assign

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    rng = np.random.default_rng(1)
    images = {"224x224": rng.standard_normal((224, 224, 3), dtype=np.float32),
              "448x672": rng.standard_normal((448, 672, 3), dtype=np.float32)}
    logits = {}
    for device in (dev, torch.device("cpu")):
        m = SegCLIP(cfg32)
        m.load_state_dict(model.state_dict())
        m = m.to(device).eval()
        bank = build_text_bank(m, VOC_CLASSES, "simple", cfg32.context_length)
        seg = ZeroShotSegmenter(m, bank, with_bg=True, bg_thresh=VOC_BG_THRESH,
                                patch_size=cfg32.vision_patch_size)
        for name, img in images.items():
            counts, routes = (attention.launches, group_assign.launches), read_routes()
            logits[name, device.type] = seg.whole(img)
            moved = (attention.launches, group_assign.launches) != counts
            check(moved == (device.type == "cuda"),
                  f"{device}: kernel launches {'' if moved else 'not '}counted")
            if device.type == "cuda":
                r = {k: n - routes[k] for k, n in read_routes().items()}
                check(r["tf32x3"] == 14 and sum(r.values()) == 14, f"float32 {name} whole: "
                      f"attention by route {r}; expected all 14 on the TF32x3 kernel")
    for name in images:
        gpu, cpu = logits[name, "cuda"], logits[name, "cpu"]
        diff = np.abs(gpu - cpu)
        agree = float((diff.max(axis=0) <= E2E_PIXEL_TOL).mean())
        argmax_agree = float((gpu.argmax(0) == cpu.argmax(0)).mean())
        print(f"phase 3: float32 {name} whole, card vs CPU: max |dlogit| "
              f"{diff.max():.3e}, median {np.median(diff):.3e}; pixels within "
              f"{E2E_PIXEL_TOL:g}: {agree:.5f}; argmax agree {argmax_agree:.5f}")
        check(np.isfinite(gpu).all() and np.isfinite(cpu).all(), f"{name}: non-finite logits")
        check(agree >= E2E_MIN_AGREE, f"{name}: only {agree:.5f} of pixels agree")
        check(argmax_agree >= E2E_MIN_AGREE, f"{name}: argmax agrees on {argmax_agree:.5f}")


# Phase 7: OpenAI's file holds the CLIP towers only; these keep the seeded
# init and must be reported missing. Its metadata tensors, as OpenAI ships.
NOT_IN_CLIP = ("clip.visual.transformer.semantic_layer2.",
               "clip.visual.transformer.layers_mae2.",
               "clip.visual.transformer.reconstruct_layer2.",
               "vis_mae_decoder.", "seq_mae_decoder.")
OPENAI_METADATA = {"input_resolution": 224, "context_length": 77, "vocab_size": 49408}
DEMO_VIS = ("input", "pred", "input_pred", "input_pred_label", "all_groups",
            "first_group", "final_group")
# Phase 8: float32 (TF32 off) predictions of the batched decode against one
# image at a time: equal on this share of pixels (only the order of fp32
# sums differs, which can move a near tie), the mIoU within this.
SHARDED_MIN_AGREE = 0.999
SHARDED_MIOU_TOL = 0.01
# Phase 9: two ranks on this machine's card(s); the float32 step at a global
# batch of DP_F32_BATCH (injected noise) against one rank, the loss within
# DP_LOSS_RTOL of itself (the same sums, split across two processes), hard
# assignments equal away from near ties; then DP_BATCH (the preset's 96)
# split in two for 1 + TRAIN_STEPS bf16 steps. Workers get DP_TIMEOUT_S.
DP_WORLD = 2
DP_F32_BATCH = 8
DP_LOSS_RTOL = 1e-4
DP_TIMEOUT_S = 480
# Phase 9, tensor parallel (the same ranks as one dp1 × tp2 grid): the
# float32 step at 1 × DP_F32_BATCH on each rank, against the 1-process step
# (the Megatron partial sums add in another order):
#  - the loss as the data-parallel step's; hard assignments equal on every
#    patch, near ties included (a flipped patch would change the gradients
#    the checks below hold);
#  - the clip norm within TP_NORM_RTOL of itself (a replicated gradient
#    counted tp times, or a sharded one left out, moves it by far more);
#  - every gathered gradient (after the clip) within TP_GRAD_RTOL·max|g| of
#    the reference's, per tensor: this is where the backward is checked;
#  - every gathered parameter within TP_MOVE_RTOL·max|Δ| + one ulp of its
#    largest value of the reference's, per tensor, Δ the reference's move in
#    this step. AdamW's first step moves each element by about ±lr whatever
#    the size of its gradient, and by lr·g/eps where |g| < eps = 1e-6, so
#    roundoff in a gradient near zero moves its element by a share of lr:
#    this check sees a tensor left unmoved (error 1·max|Δ|), moved the other
#    way (2·max|Δ|) or put together wrongly, not the gradients' precision.
TP_NORM_RTOL = 1e-5
TP_GRAD_RTOL = 1e-4
TP_MOVE_RTOL = 0.5
# Phase 12 in phase 9's ranks: the dp1 × tp2 bf16 steps again with remat,
# 1 + TP_REMAT_STEPS of them, each loss within RESUME_LOSS_RTOL of the
# non-remat step's (bit for bit expected: gloo sums in a fixed order).
TP_REMAT_STEPS = 2


def openai_layout(sd: dict, first_stage_layer: int) -> dict:
    """The port's state dict → OpenAI CLIP's layout: the CLIP towers only,
    no `clip.` prefix, layers0.N / layers2.N back to resblocks.N."""
    out = {}
    for key, value in sd.items():
        if not key.startswith("clip.") or key.startswith(NOT_IN_CLIP):
            continue
        key = key[len("clip."):]
        for stage, offset in (("layers0", 0), ("layers2", first_stage_layer)):
            head = f"visual.transformer.{stage}."
            if key.startswith(head):
                n, rest = key[len(head):].split(".", 1)
                key = f"visual.transformer.resblocks.{int(n) + offset}.{rest}"
        out[key] = value
    return out


def save_torchscript(path: str, tensors: dict) -> None:
    """A TorchScript archive whose state_dict() is `tensors`, as OpenAI's
    ViT-B-16.pt is: a module tree by the keys' dots, floating tensors as
    parameters, the metadata scalars as buffers."""
    import warnings
    root = torch.nn.Module()
    for key, value in tensors.items():
        *path_, leaf = key.split(".")
        node = root
        for part in path_:
            if not hasattr(node, part):
                node.add_module(part, torch.nn.Module())
            node = getattr(node, part)
        if value.is_floating_point():
            node.register_parameter(leaf, torch.nn.Parameter(value, requires_grad=False))
        else:
            node.register_buffer(leaf, value)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=DeprecationWarning)
        torch.jit.script(root).save(path)


class CountingCalls:
    """Records the launch counters' change, and the time to a device sync,
    over each call of `owner.attr` for the length of a `with` block."""

    def __init__(self, owner, attr: str):
        self.owner, self.attr, self.calls = owner, attr, []

    def __enter__(self):
        self.orig = getattr(self.owner, self.attr)
        probe = self

        def counted(*args, **kw):
            before = read_counters()
            out, ms = timed(lambda: probe.orig(*args, **kw))
            probe.calls.append((counter_delta(before), ms))
            return out
        setattr(self.owner, self.attr, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.orig)


def demo_files(stem: str) -> set:
    """The files the demo writes for one image in every --vis mode."""
    out = set()
    for vis in DEMO_VIS:
        if vis == "pred":
            out.add(f"pred/{stem}.png")
        elif vis == "all_groups":
            out.add(f"all_groups/{stem}_layer0.jpg")
        else:
            out.add(f"{vis}/{stem}.jpg")
    return out


def phase_ingest_demo(dev, model, tmp: str) -> tuple:
    """Phase 7: the seeded ViT-B/16 written as OpenAI's TorchScript archive
    and as a segclip.bin, read back through load_model (architecture
    inferred, tensors bit for bit, the missing set), then cli.demo on the
    card in single-image and dataset mode over phase 6's eval split.
    Returns the launch counts of the demo runs and the segclip.bin path."""
    from PIL import Image
    from segclip_tpu_torch.checkpoint.torch_convert import (load_torch_state_dict,
                                                            to_port_layout)
    from segclip_tpu_torch.cli import demo
    from segclip_tpu_torch.cli.common import load_model
    from segclip_tpu_torch.config import ModelConfig
    from segclip_tpu_torch.evalseg.datasets import DATASET_SPECS

    cfg = ModelConfig()
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    paths = {"OpenAI ViT-B-16.pt": os.path.join(tmp, "ViT-B-16.pt"),
             "segclip.bin": os.path.join(tmp, "segclip.bin")}
    t0 = time.perf_counter()
    tensors = {k: v.half() for k, v in openai_layout(sd, cfg.first_stage_layer).items()}
    tensors.update({k: torch.tensor(v) for k, v in OPENAI_METADATA.items()})
    save_torchscript(paths["OpenAI ViT-B-16.pt"], tensors)
    torch.save({**sd, "vis_mae_decoder.decoder_pos_embed":
                model.vis_mae_decoder.pos_table[None].cpu()}, paths["segclip.bin"])
    print(f"phase 7: checkpoint ingest and the demo; wrote "
          + ", ".join(f"{n} ({os.path.getsize(p) / 2**20:.0f} MiB)" for n, p in paths.items())
          + f" in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        t0 = time.perf_counter()
        loaded, inferred = load_model(path, ModelConfig(), dev)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        check(inferred == cfg, f"{name}: inferred {inferred}, expected ModelConfig()")
        provided = to_port_layout(load_torch_state_dict(path), inferred.first_stage_layer)
        provided.pop("vis_mae_decoder.decoder_pos_embed", None)
        state = {k: v.cpu() for k, v in loaded.state_dict().items()}
        # what was written, cast to fp32: OpenAI's file holds fp16 values
        cast = (lambda v: v.half().float()) if name.startswith("OpenAI") else (lambda v: v)
        bad = [k for k, v in provided.items()
               if not (torch.equal(state[k], v) and torch.equal(v, cast(sd[k])))]
        check(not bad, f"{name}: tensors not loaded bit for bit: {bad[:5]}")
        missing = sorted(set(state) - set(provided))
        want = sorted(k for k in state if k.startswith(NOT_IN_CLIP)) \
            if name.startswith("OpenAI") else []
        check(missing == want, f"{name}: missing {missing[:5]}…, expected {want[:5]}…")
        seed0 = [k for k in missing if not torch.equal(state[k], sd[k])]
        check(not seed0, f"{name}: missing tensors not at the seeded init: {seed0[:5]}")
        prefixes = sorted({k.split(".")[3] if k.startswith("clip.") else k.split(".")[0]
                           for k in missing})
        print(f"  {name}: load_model {ingest_s:.2f} s (read, seeded init, merge, to the "
              f"card); inferred ModelConfig() exactly; {len(provided)} tensors loaded bit "
              f"for bit after the fp32 cast; missing "
              f"{len(missing)} tensors ({', '.join(prefixes) or 'none'}), kept at the "
              f"seeded init")
        del loaded

    spec = DATASET_SPECS["shapes"]
    eval_root = os.path.join(tmp, "shapes", "eval")
    with open(os.path.join(eval_root, spec.split)) as f:
        stems = [line.strip() for line in f if line.strip()][:CORPUS_EVAL_N]
    image = stems[0] + spec.img_suffix
    per_request = {"attention_fwd": 2 * (cfg.vision_layers + cfg.cross_layer),
                   "attention_bwd": 0, "group_assign": 2, "group_assign_st": 0,
                   "plain_route": 0}
    runs = (("single image (slide)", ["--input", os.path.join(eval_root, "JPEGImages", image),
                                      "--init-model", paths["segclip.bin"]],
             [os.path.splitext(image)[0]]),
            (f"dataset, first {CORPUS_EVAL_N} (whole)",
             ["--data-root", eval_root, "--first-n", str(CORPUS_EVAL_N),
              "--init-model", paths["OpenAI ViT-B-16.pt"]], stems))
    reset_counters()
    for i, (name, argv, names) in enumerate(runs):
        out = os.path.join(tmp, f"demo{i}")
        before = read_counters()
        with CountingCalls(demo, "_run_one") as calls:
            demo.main(argv + ["--dataset", "shapes", "--vis", *DEMO_VIS,
                              "--output-dir", out])
        delta = counter_delta(before)
        files = {os.path.relpath(os.path.join(d, f), out) for d, _, fs in os.walk(out)
                 for f in fs if f != "log.txt"}
        want = set().union(*(demo_files(n) for n in names))
        check(files == want, f"demo {name}: wrote {sorted(files)}, expected {sorted(want)}")
        for n in names:
            labels = np.asarray(Image.open(os.path.join(out, "pred", f"{n}.png")))
            check(labels.max() < len(spec.classes), f"demo {name}: label out of range")
        check(all(c == per_request for c, _ in calls.calls),
              f"demo {name}: launches per request {[c for c, _ in calls.calls]}, "
              f"expected {per_request}")
        bank = {k: delta[k] - sum(c[k] for c, _ in calls.calls) for k in delta}
        check(bank == {**{k: 0 for k in delta}, "attention_fwd": cfg.transformer_layers},
              f"demo {name}: launches outside the requests {bank}")
        ms = [t for _, t in calls.calls]
        print(f"  demo {name}: {len(files)} files for {len(names)} image(s), every --vis "
              f"mode; per request (predict + group map + {len(DEMO_VIS)} images written), "
              f"in order: {' '.join(f'{t:.1f}' for t in ms)} ms; launches per request "
              f"{per_request['attention_fwd']} "
              f"attention / {per_request['group_assign']} grouping, text bank "
              f"{cfg.transformer_layers}")
    return read_counters(), paths["segclip.bin"]


def make_voc(root: str, shapes) -> str:
    """A VOC-layout split of random images of the given (H, W) and random
    labels, seeded."""
    from PIL import Image
    rng = np.random.default_rng(12)
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i, (h, w) in enumerate(shapes):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, "JPEGImages", f"img{i}.jpg"))
        Image.fromarray(rng.integers(0, 21, (h, w)).astype(np.uint8)).save(
            os.path.join(root, "SegmentationClass", f"img{i}.png"))
    with open(os.path.join(root, "ImageSets/Segmentation/val.txt"), "w") as f:
        f.write("".join(f"img{i}\n" for i in range(len(shapes))))
    return root


def eval_cli_args(voc: str, model_path: str) -> list:
    """Phase 8's eval CLI run: one image per call, float32, so that one and
    two processes run the same decode calls."""
    return ["--dataset", "voc", "--data-root", voc, "--init-model", model_path,
            "--compute-dtype", "float32"]


def phase_sharded_eval(dev, model, cfg, tmp: str, model_path: str) -> tuple:
    """Phase 8: the sharded evaluator at 1 and SHARDED_PER_CALL images per
    call against one image at a time, float32 and bf16, on SHARDED_IMAGES;
    then the eval CLI in one process (its metrics are held against two
    processes in phase 9's workers). Returns the launch counts of the bf16
    sharded run, and the CLI's metrics."""
    from segclip_tpu_torch.cli import eval_zeroshot
    from segclip_tpu_torch.evalseg.datasets import DATASET_SPECS, SegEvalDataset
    from segclip_tpu_torch.evalseg.inference import (evaluate_dataset,
                                                     evaluate_dataset_sharded)
    from segclip_tpu_torch.models.segclip import SegCLIP

    voc = make_voc(os.path.join(tmp, "voc8"), SHARDED_IMAGES)
    spec = DATASET_SPECS["voc"]
    dataset = SegEvalDataset(spec, voc)
    samples = list(dataset)
    images, shapes = [s.image for s in samples], [s.orig_shape for s in samples]
    print(f"phase 8: the sharded evaluator, {len(samples)} images "
          f"({' '.join(f'{h}x{w}' for h, w in SHARDED_IMAGES)}), {SHARDED_PER_CALL} per "
          f"decode call")
    counts = None
    for dtype in ("float32", "bfloat16"):
        mcfg = dataclasses.replace(cfg, compute_dtype=dtype)
        m = model
        if dtype != cfg.compute_dtype:
            m = SegCLIP(mcfg)
            m.load_state_dict(model.state_dict())
            m = m.to(dev).eval()
        seg = eval_zeroshot.build_segmenter(m, mcfg, spec)
        windows = []
        decode = seg._decode
        seg._decode = lambda crops, h, w: (windows.append(len(crops)), decode(crops, h, w))[1]

        def sequential():
            return [seg.predict(x, o) for x, o in zip(images, shapes)]

        def batched():
            return [p for i in range(0, len(images), SHARDED_PER_CALL)
                    for p in seg.predict_batch(images[i:i + SHARDED_PER_CALL],
                                               shapes[i:i + SHARDED_PER_CALL])]

        sequential(), batched()                           # warm
        windows.clear()
        seq, seq_ms = timed(sequential)
        bat, bat_ms = timed(batched)
        calls = windows[len(images):]
        del seg._decode
        check(max(calls) == SHARDED_MAX_WINDOWS and len(calls) == 2,
              f"windows per batched decode call {calls}")
        pixels = sum(p.size for p in seq)
        flips = sum(int((a != b).sum()) for a, b in zip(seq, bat)) / pixels
        want = evaluate_dataset(seg, dataset)
        reset_counters()
        got, sharded_ms = timed(lambda: evaluate_dataset_sharded(
            seg, dataset, images_per_device=SHARDED_PER_CALL))
        if dtype == "bfloat16":
            counts = read_counters()
        d_miou = abs(got["mIoU"] - want["mIoU"])
        print(f"  {dtype}: one image per call {len(images) * 1e3 / seq_ms:.1f} img/s "
              f"({seq_ms:.1f} ms), {SHARDED_PER_CALL} per call ({calls} windows) "
              f"{len(images) * 1e3 / bat_ms:.1f} img/s ({bat_ms:.1f} ms); predictions differ "
              f"on {flips:.2e} of {pixels} pixels; mIoU {want['mIoU']:.4f} sequential, "
              f"{got['mIoU']:.4f} sharded (|Δ| {d_miou:.2e}; evaluate_dataset_sharded with "
              f"image decode {sharded_ms:.1f} ms)")
        check(np.isfinite(got["mIoU"]), f"{dtype}: mIoU {got['mIoU']}")
        if dtype == "float32":
            check(1 - flips >= SHARDED_MIN_AGREE, f"float32: {flips} of pixels flip")
            check(d_miou <= SHARDED_MIOU_TOL, f"float32: mIoU off by {d_miou}")
    per_call = {"attention_fwd": cfg.vision_layers + cfg.cross_layer, "attention_bwd": 0,
                "group_assign": 1, "group_assign_st": 0, "plain_route": 0}
    want_counts = {k: 2 * v for k, v in per_call.items()}
    check(counts == want_counts, f"sharded eval launches {counts}, expected {want_counts}")
    single = eval_zeroshot.main(eval_cli_args(voc, model_path)
                                + ["--output-dir", os.path.join(tmp, "eval_one")])
    print(f"  eval CLI, one process, float32: mIoU {single['mIoU']:.4f}; launches of the "
          f"bf16 sharded run {counts}")
    return counts, single, voc


def dp_f32_step(dev, rank: int, world: int, shard: bool = False) -> tuple:
    """One float32 training step at full width on this rank's share of a
    DP_F32_BATCH batch with injected noise; the mean loss over the ranks,
    the clip norm, the SemanticLearner's hard assignments and margins of
    this rank's rows, and the model after the step (its gradients, clipped,
    kept). With `shard`, the model is split over the model row of the grid
    already built (parallel/gspmd.shard_model_); `rank` and `world` are
    then the data rank and size."""
    from segclip_tpu_torch.config import Config, ModelConfig
    from segclip_tpu_torch.models.segclip import init_segclip
    from segclip_tpu_torch.parallel import gspmd
    from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step

    mcfg = ModelConfig(compute_dtype="float32")
    cfg = Config(model=mcfg)
    b, g, l = DP_F32_BATCH, mcfg.group_num, mcfg.num_patches
    kept = int((l + 1) * (1 - mcfg.mae_vis_mask_ratio)) - 1
    rows = slice(rank * b // world, (rank + 1) * b // world)
    rng = np.random.default_rng(5)
    noise = {"gumbel": rng.gumbel(size=(b, g, l)), "gumbel_mae": rng.gumbel(size=(b, g, kept)),
             "mask_vis": rng.random((b, l + 1))}
    noise = {k: torch.from_numpy(v[rows].astype(np.float32)).to(dev) for k, v in noise.items()}
    batch = {k: v[rows] for k, v in synthetic_batch(b, mcfg, 1, dev).items()}
    model = init_segclip(mcfg, seed=0, device=dev)
    if shard:
        gspmd.shard_model_(model)
    step = make_train_step(model, create_optimizer(model, cfg, t_total=100), cfg)
    probe = GroupingProbe(model.clip.visual.transformer.semantic_layer2,
                          [noise["gumbel"], noise["gumbel_mae"]])
    metrics = step(TrainState(), batch, noise)
    probe.handle.remove()
    return float(metrics["loss"]), float(metrics["grad_norm"]), probe.records, model


def gathered_grads(model) -> dict:
    """The full gradient of every parameter of a sharded model that has
    one, on the CPU; a collective over the model row."""
    from segclip_tpu_torch.parallel import dist, gspmd
    out = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        g = p.grad.detach()
        if hasattr(p, "model_shard"):
            g = gspmd.assemble(dist.all_gather(g, dist.model_group()), p.model_shard)
        out[name] = g.cpu()
    return out


def dp_bf16_steps(dev, shard: bool = False, remat: bool = False,
                  steps: int = TRAIN_STEPS) -> dict:
    """1 + `steps` bf16 steps at ViT-B/16 width on this data rank's
    TRAIN_BATCH // DP_WORLD rows of phase 4's B = 96 batch: losses, launches
    per step, times, the bytes all-reduced over the model row per step, peak
    memory and a checksum of the replicated parameters. With `shard`, the
    model is split over the model row of the grid already built; with
    `remat`, ModelConfig.remat is on."""
    from segclip_tpu_torch.config import Config, ModelConfig
    from segclip_tpu_torch.models.segclip import init_segclip
    from segclip_tpu_torch.parallel import dist, gspmd
    from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step

    cfg = Config(model=ModelConfig(remat=remat))
    b, r = TRAIN_BATCH // DP_WORLD, dist.data_rank()
    batch = {k: v[r * b:(r + 1) * b]
             for k, v in synthetic_batch(TRAIN_BATCH, cfg.model, 0, dev).items()}
    torch.cuda.reset_peak_memory_stats(dev)
    model = init_segclip(cfg.model, seed=0, device=dev)
    if shard:
        gspmd.shard_model_(model)
    step = make_train_step(model, create_optimizer(model, cfg, t_total=100), cfg)
    state = TrainState(step=0, seed=0)
    out = {"loss": [], "skipped": [], "counts": [], "ms": [], "bytes": []}
    for _ in range(1 + steps):
        reset_counters()
        sent = gspmd.model_group_sum.bytes
        metrics, ms = timed(lambda: step(state, batch))
        out["counts"].append(read_counters())
        out["bytes"].append(gspmd.model_group_sum.bytes - sent)
        out["loss"].append(float(metrics["loss"]))
        out["skipped"].append(float(metrics["skipped_nan"]))
        out["ms"].append(ms)
    out["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    out["checksum"] = float(sum(p.double().sum() for p in model.parameters()
                                if not hasattr(p, "model_shard")))
    return out


def train_dp_args(tmp: str, tp: int = 1) -> list:
    """Phase 9's train CLI: the phase-6 preset for one epoch on the rgb
    transport, the one phase 6's runs (yuv420, device_aug) leave out; at
    `tp` > 1 with train.tensor_parallelism=tp (at dp1 × tp2 each rank
    steps on the whole B = 96 batch with half the heads and MLP rows)."""
    return ["--preset", "shapes-learnability", "--data-dir", os.path.join(tmp, "shapes"),
            "--epochs", "1", "--num-workers", "0", "--n-display", "1",
            "--output-dir", os.path.join(tmp, "tp_run" if tp > 1 else "dp_run"),
            "--opts", "data.transfer=rgb", f"train.tensor_parallelism={tp}"]


def dp_rank(rank: int, world: int, tmp: str, voc: str, model_path: str) -> dict:
    """Phases 8 and 9 on one of `world` ranks (a spawned process): the
    float32 and bf16 data-parallel steps in one process group, then the same
    steps on a dp1 × tp2 grid of that group; then the eval CLI, the train
    CLI and the train CLI at train.tensor_parallelism=2, each starting its
    own group from --dist-*."""
    from segclip_tpu_torch.cli import eval_zeroshot
    from segclip_tpu_torch.cli import train as train_cli
    from segclip_tpu_torch.kernels import build
    from segclip_tpu_torch.parallel import dist, gspmd

    build.load()
    dev = dist.init_distributed("cuda", f"file://{tmp}/rendezvous_steps", world, rank)
    out = {"device": str(dev), "backend": dist.backend(), "cards": torch.cuda.device_count()}
    try:
        dist.warmup()
        out["f32_loss"], _, records, _ = dp_f32_step(dev, rank, world)
        torch.save(records, os.path.join(tmp, f"dp_f32_records_{rank}.pt"))
        torch.cuda.empty_cache()
        out["bf16"] = dp_bf16_steps(dev)
        torch.cuda.empty_cache()
        # the same ranks as one model row: dp1 × tp2
        dist.init_grid(world)
        dist.warmup()
        out["tp_f32_loss"], out["tp_f32_grad_norm"], records, model = dp_f32_step(
            dev, 0, 1, shard=True)
        torch.save(records, os.path.join(tmp, f"tp_f32_records_{rank}.pt"))
        full, _ = gspmd.gather_state_dict(model)
        grads = gathered_grads(model)
        if rank == 0:
            torch.save({"params": {k: v.cpu() for k, v in full.items()}, "grads": grads},
                       os.path.join(tmp, "tp_f32_step.pt"))
        del model, full, grads
        torch.cuda.empty_cache()
        out["tp_bf16"] = dp_bf16_steps(dev, shard=True)
        torch.cuda.empty_cache()
        out["tp_bf16_remat"] = dp_bf16_steps(dev, shard=True, remat=True, steps=TP_REMAT_STEPS)
    finally:
        dist.shutdown()
    torch.cuda.empty_cache()
    flags = ["--dist-num-processes", str(world), "--dist-process-id", str(rank)]
    reset_counters()
    result = eval_zeroshot.main(eval_cli_args(voc, model_path) + [
        "--output-dir", os.path.join(tmp, f"eval_rank{rank}"),
        "--dist-coordinator", f"file://{tmp}/rendezvous_eval"] + flags)
    out["eval_cli"] = {"metrics": {k: result[k] for k in ("mIoU", "mAcc", "aAcc")},
                       "counts": read_counters()}
    with CountingPath() as path:
        reset_counters()
        result = train_cli.main(train_dp_args(tmp) + [
            "--dist-coordinator", f"file://{tmp}/rendezvous_train"] + flags)
        counts = read_counters()
    out["train_cli"] = {"steps": path.steps, "requests": path.requests, "counts": counts,
                        "final_loss": result["final_loss"]}
    del result
    torch.cuda.empty_cache()
    with CountingPath() as path:
        reset_counters()
        t0 = time.perf_counter()
        result = train_cli.main(train_dp_args(tmp, tp=world) + [
            "--dist-coordinator", f"file://{tmp}/rendezvous_train_tp"] + flags)
        seconds = time.perf_counter() - t0
        counts = read_counters()
    out["train_tp_cli"] = {"steps": path.steps, "requests": path.requests, "counts": counts,
                           "final_loss": result["final_loss"], "seconds": seconds}
    return out


def dp_worker(rank: int, world: int, tmp: str, voc: str, model_path: str) -> None:
    """Entry point of a spawned rank: runs dp_rank with its output in
    <tmp>/dp_rank<r>.log and its result in <tmp>/dp_rank<r>.json."""
    import contextlib
    import traceback
    with open(os.path.join(tmp, f"dp_rank{rank}.log"), "w") as log, \
            contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        try:
            result = dp_rank(rank, world, tmp, voc, model_path)
            result["routes"] = read_routes()
        except BaseException:
            traceback.print_exc()
            raise
    with open(os.path.join(tmp, f"dp_rank{rank}.json"), "w") as f:
        json.dump(result, f)


def run_ranks(world: int, args: tuple) -> list:
    """Spawn `world` dp_worker processes and wait for them (DP_TIMEOUT_S);
    every one must exit 0. Returns their results."""
    import multiprocessing as mp
    tmp = args[0]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dp_worker, args=(r, world, *args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DP_TIMEOUT_S
    try:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    for r, p in enumerate(procs):
        if p.exitcode != 0:
            with open(os.path.join(tmp, f"dp_rank{r}.log")) as f:
                print(f"  rank {r} exited {p.exitcode}; the end of its log:\n"
                      + f.read()[-6000:])
        check(p.exitcode == 0, f"rank {r} of {world} exited {p.exitcode}")
    results = []
    for r in range(world):
        with open(os.path.join(tmp, f"dp_rank{r}.json")) as f:
            results.append(json.load(f))
        add_routes(ROUTES_ELSEWHERE, results[-1]["routes"])
    return results


def phase_data_parallel(dev, tmp: str, smi: str, warm_step_ms: float, voc: str,
                        model_path: str, eval_one: dict) -> tuple:
    """Phase 9 (with the end of phase 8): DP_WORLD ranks on this machine,
    spawned; one card each over NCCL where there are enough cards, else
    sharing the card over gloo. Returns the launch counts of the ranks'
    training and of their sharded eval."""
    from segclip_tpu_torch.cli import eval_zeroshot
    from segclip_tpu_torch.config import ModelConfig
    from segclip_tpu_torch.models.segclip import init_segclip

    cfg = ModelConfig()
    ref_loss, ref_norm, ref_records, ref_model = dp_f32_step(dev, 0, 1)
    ref_step = {"params": {k: v.detach().cpu() for k, v in ref_model.state_dict().items()},
                "grads": {n: p.grad.detach().cpu() for n, p in ref_model.named_parameters()
                          if p.grad is not None},
                "init": init_segclip(ModelConfig(compute_dtype="float32"), seed=0).state_dict()}
    del ref_model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(DP_WORLD, (tmp, voc, model_path))
    ranks_s = time.perf_counter() - t0
    route = ("NCCL, one card per rank" if ranks[0]["backend"] == "nccl" else
             "gloo, the ranks share the card, collectives through host copies")
    print(f"phase 9: data parallel, {DP_WORLD} ranks on {ranks[0]['cards']} card(s) "
          f"({smi}): backend {ranks[0]['backend']} ({route}); devices "
          f"{[r['device'] for r in ranks]}; the ranks ran {ranks_s:.1f} s (spawn included)")
    check(len({r["backend"] for r in ranks}) == 1, "ranks disagree on the backend")
    check(ranks[0]["backend"] == ("nccl" if ranks[0]["cards"] >= DP_WORLD else "gloo"),
          f"backend {ranks[0]['backend']} with {ranks[0]['cards']} card(s)")

    losses = [r["f32_loss"] for r in ranks]
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    n_near = n_bad = 0
    b = DP_F32_BATCH // DP_WORLD
    for r in range(DP_WORLD):
        records = torch.load(os.path.join(tmp, f"dp_f32_records_{r}.pt"), weights_only=True)
        for (hard, _), (hard_ref, margin) in zip(records, ref_records):
            near = margin[r * b:(r + 1) * b] < NEAR_TIE
            differ = (hard != hard_ref[r * b:(r + 1) * b]).any(dim=1)
            n_near += int(near.sum())
            n_bad += int((differ & ~near).sum())
    print(f"  float32 step, {DP_WORLD} × {b} against 1 × {DP_F32_BATCH}, injected noise: "
          f"loss {losses[0]!r} (every rank: {losses[0] == losses[1]}) against {ref_loss!r}, "
          f"rel {rel:.2e}; hard assignments differ on {n_bad} clear patches, {n_near} "
          f"near-tie patches")
    check(losses[0] == losses[1], f"ranks report other losses {losses}")
    check(rel <= DP_LOSS_RTOL, f"float32 DP loss rel {rel}")
    check(n_bad == 0, f"DP hard assignments differ on {n_bad} clear patches")

    expected = train_path_counts(cfg)
    per_rank = TRAIN_BATCH // DP_WORLD
    for r, res in enumerate(ranks):
        bf = res["bf16"]
        check(all(c == expected for c in bf["counts"]),
              f"rank {r}: launches per step {bf['counts']}, expected {expected}")
        check(all(np.isfinite(bf["loss"])) and not any(bf["skipped"]),
              f"rank {r}: losses {bf['loss']} skipped {bf['skipped']}")
        warm = sorted(bf["ms"][1:])
        print(f"  bf16, rank {r}: {1 + TRAIN_STEPS} steps at {per_rank} "
              f"({DP_WORLD} × {per_rank} = {TRAIN_BATCH}): losses "
              f"{' '.join(f'{v:.5f}' for v in bf['loss'])}; warm step median "
              f"{statistics.median(warm):.2f} ms (min {warm[0]:.2f}, max {warm[-1]:.2f}), "
              f"{TRAIN_BATCH * 1e3 / statistics.median(warm):.1f} img/s for the pair; "
              f"launches per step {bf['counts'][0]}")
    check(ranks[0]["bf16"]["loss"] == ranks[1]["bf16"]["loss"]
          and ranks[0]["bf16"]["checksum"] == ranks[1]["bf16"]["checksum"],
          "the ranks' losses or parameters differ")
    print(f"  bf16, one rank at {TRAIN_BATCH} (phase 4): warm step median "
          f"{warm_step_ms:.2f} ms, {TRAIN_BATCH * 1e3 / warm_step_ms:.1f} img/s; the ranks' "
          f"parameters equal after {1 + TRAIN_STEPS} steps")

    metrics = [r["eval_cli"]["metrics"] for r in ranks]
    want = {k: eval_one[k] for k in ("mIoU", "mAcc", "aAcc")}
    print(f"phase 8 (end): eval CLI at {DP_WORLD} ranks, float32: {metrics} against one "
          f"process {want}; launches per rank "
          f"{[r['eval_cli']['counts'] for r in ranks]}")
    check(all(m == want for m in metrics), "the ranks' eval metrics differ from one process")

    expected_request = eval_request_counts(cfg)
    steps = len(ranks[0]["train_cli"]["steps"])
    for r, res in enumerate(ranks):
        tc = res["train_cli"]
        check(all(c == expected for c in tc["steps"]) and len(tc["steps"]) == steps,
              f"rank {r}: train CLI launches per step {tc['steps']}")
        check(len(tc["requests"]) == (CORPUS_EVAL_N if r == 0 else 0)
              and all(c == expected_request for c in tc["requests"]),
              f"rank {r}: eval requests {tc['requests']}")
    run = os.path.join(tmp, "dp_run")
    logged = read_metrics(run)
    with open(os.path.join(run, "log.txt")) as f:
        step_times = [float(t) for t in re.findall(r"Time/step ([0-9.]+)", f.read())]
    mious = [m["miou"] for m in logged if "miou" in m]
    check(sorted(os.listdir(run)) == ["best.json", "ckpt_best", "ckpt_epoch_0", "log.txt",
                                      "metrics.jsonl"], f"dp run wrote {os.listdir(run)}")
    check(len([m for m in logged if "loss" in m]) == steps == 2 and len(mious) == 1,
          f"dp run metrics {logged}")
    single = eval_zeroshot.main(["--dataset", "shapes", "--data-root",
                                 os.path.join(tmp, "shapes", "eval"), "--init-model",
                                 os.path.join(run, "ckpt_epoch_0", "model.pt"),
                                 "--output-dir", os.path.join(tmp, "dp_eval")])
    print(f"  cli.train --dist-* at {DP_WORLD} ranks, 1 epoch of phase 6's corpus on rgb: "
          f"{steps} steps of {DP_WORLD} × {per_rank}, Time/step "
          f"{' '.join(f'{t * 1e3:.1f}' for t in step_times)} ms, final loss "
          f"{ranks[0]['train_cli']['final_loss']:.5f} on every rank: "
          f"{ranks[0]['train_cli']['final_loss'] == ranks[1]['train_cli']['final_loss']}; "
          f"rank 0's eval mIoU {mious[0]:.4f}; its model.pt in a one-process eval: mIoU "
          f"{single['mIoU']:.4f}")
    check(ranks[0]["train_cli"]["final_loss"] == ranks[1]["train_cli"]["final_loss"],
          "the ranks' final losses differ")
    check(abs(single["mIoU"] - mious[0]) <= SHARDED_MIOU_TOL,
          f"rank 0's model.pt evaluates to {single['mIoU']}, the run logged {mious[0]}")
    train = {k: sum(sum(c[k] for c in r["bf16"]["counts"]) + r["train_cli"]["counts"][k]
                    for r in ranks) for k in expected}
    evals = {k: sum(r["eval_cli"]["counts"][k] for r in ranks) for k in expected}
    tp = check_tensor_parallel(ranks, tmp, smi, warm_step_ms,
                               (ref_loss, ref_norm, ref_records, ref_step),
                               expected, expected_request)
    return train, evals, tp


def check_tensor_parallel(ranks, tmp: str, smi: str, warm_step_ms: float, ref,
                          expected: dict, expected_request: dict) -> dict:
    """Phase 9, tensor parallel: the ranks' dp1 × tp2 results against the
    1-process float32 step `ref` (loss, clip norm, grouping records; the
    parameters after the step, the gradients and the initial parameters),
    the bf16 steps' launches, those steps again with remat (phase 12), and
    the tp = 2 CLI run's checkpoint (the tp = 1 layout) and eval. Returns
    the launch counts of the path."""
    import math
    from segclip_tpu_torch.cli import eval_zeroshot
    from segclip_tpu_torch.config import ModelConfig
    from segclip_tpu_torch.models.segclip import SegCLIP

    ref_loss, ref_norm, ref_records, ref_step = ref
    losses = [r["tp_f32_loss"] for r in ranks]
    norms = [r["tp_f32_grad_norm"] for r in ranks]
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    norm_rel = abs(norms[0] - ref_norm) / ref_norm
    n_near = n_differ = 0
    for r in range(DP_WORLD):
        records = torch.load(os.path.join(tmp, f"tp_f32_records_{r}.pt"), weights_only=True)
        for (hard, _), (hard_ref, margin) in zip(records, ref_records):
            n_near += int((margin < NEAR_TIE).sum())
            n_differ += int((hard != hard_ref).any(dim=1).sum())
    got = torch.load(os.path.join(tmp, "tp_f32_step.pt"), weights_only=True)
    params, grads = got["params"], got["grads"]
    check(params.keys() == ref_step["params"].keys(),
          "the gathered TP parameters' names differ")
    check(grads.keys() == ref_step["grads"].keys(), "different parameters got gradients")
    grad_worst = max(((grads[n] - g).abs().max().item() / g.abs().max().item()
                      if g.abs().max().item() else (grads[n] - g).abs().max().item(), n)
                     for n, g in ref_step["grads"].items())
    move_worst, off = (0.0, ""), []
    for n, p_ref in ref_step["params"].items():
        move = (p_ref.double() - ref_step["init"][n].double()).abs().max().item()
        ulp = 2.0 ** (math.frexp(p_ref.abs().max().item())[1] - 24)
        err = (params[n].double() - p_ref.double()).abs().max().item()
        if err > TP_MOVE_RTOL * move + ulp:
            off.append(f"{n}: max |err| {err:.3e}, moved {move:.3e}, one ulp {ulp:.1e}")
        if move:
            move_worst = max(move_worst, (err / move, n))
    print(f"  tensor parallel, dp1 × tp{DP_WORLD} on the same ranks ({smi}): float32 step "
          f"at 1 × {DP_F32_BATCH} on each rank, injected noise: loss {losses[0]!r} (every "
          f"rank: {losses[0] == losses[1]}) against {ref_loss!r}, rel {rel:.2e}; clip norm "
          f"{norms[0]!r} against {ref_norm!r}, rel {norm_rel:.2e} (tol {TP_NORM_RTOL:g}); "
          f"hard assignments differ on {n_differ} patches ({n_near} near-tie patches); "
          f"gathered gradients on {len(grads)} tensors, worst {grad_worst[0]:.2e}·max|g| "
          f"at {grad_worst[1]} (tol {TP_GRAD_RTOL:g}); gathered parameters on "
          f"{len(params)} tensors, worst {move_worst[0]:.2e}·max|Δ| at {move_worst[1]} "
          f"(tol {TP_MOVE_RTOL:g}·max|Δ| + 1 ulp)")
    check(losses[0] == losses[1] and norms[0] == norms[1],
          f"TP ranks report other losses {losses} or clip norms {norms}")
    check(rel <= DP_LOSS_RTOL, f"float32 TP loss rel {rel}")
    check(norm_rel <= TP_NORM_RTOL, f"float32 TP clip norm rel {norm_rel}")
    check(n_differ == 0, f"TP hard assignments differ on {n_differ} patches")
    check(grad_worst[0] <= TP_GRAD_RTOL,
          f"TP gradient of {grad_worst[1]} off by {grad_worst[0]}·max|g|")
    check(not off, f"TP parameters after the step off: {off[:5]}")

    per_rank = TRAIN_BATCH // DP_WORLD
    for r, res in enumerate(ranks):
        tp, dp = res["tp_bf16"], res["bf16"]
        check(all(c == expected for c in tp["counts"]),
              f"rank {r}: TP launches per step {tp['counts']}, expected {expected}")
        check(all(np.isfinite(tp["loss"])) and not any(tp["skipped"]),
              f"rank {r}: TP losses {tp['loss']} skipped {tp['skipped']}")
        warm = sorted(tp["ms"][1:])
        print(f"  bf16, rank {r}: {1 + TRAIN_STEPS} dp1 × tp{DP_WORLD} steps at "
              f"{per_rank} ({smi}): losses {' '.join(f'{v:.5f}' for v in tp['loss'])}; "
              f"warm step median {statistics.median(warm):.2f} ms (min {warm[0]:.2f}, "
              f"max {warm[-1]:.2f}); all-reduced over the model row per step "
              f"{tp['bytes'][1] / 1e9:.4f} GB ({tp['bytes'][1]} bytes, through the host "
              f"under gloo); peak memory {tp['peak_mib']:.0f} MiB (data parallel at "
              f"{per_rank}: {statistics.median(sorted(dp['ms'][1:])):.2f} ms, "
              f"{dp['peak_mib']:.0f} MiB; phase 4, one rank at {TRAIN_BATCH}: "
              f"{warm_step_ms:.2f} ms); launches per step {tp['counts'][0]}")
        check(len(set(tp["bytes"])) == 1, f"rank {r}: bytes per step {tp['bytes']}")
    check(ranks[0]["tp_bf16"]["loss"] == ranks[1]["tp_bf16"]["loss"]
          and ranks[0]["tp_bf16"]["checksum"] == ranks[1]["tp_bf16"]["checksum"],
          "the TP ranks' losses or replicated parameters differ")
    expected_remat = train_path_counts(ModelConfig(remat=True))
    for r, res in enumerate(ranks):
        rm, tp = res["tp_bf16_remat"], res["tp_bf16"]
        ref_loss = tp["loss"][:len(rm["loss"])]
        worst = max(abs(a - b) / abs(b) for a, b in zip(rm["loss"], ref_loss))
        warm = sorted(rm["ms"][1:])
        print(f"  phase 12, rank {r}: {len(rm['loss'])} dp1 × tp{DP_WORLD} bf16 steps at "
              f"{per_rank} with remat ({smi}): losses "
              f"{' '.join(f'{v:.5f}' for v in rm['loss'])} against the steps without it "
              f"{' '.join(f'{v:.5f}' for v in ref_loss)} (bit for bit: {rm['loss'] == ref_loss}"
              f", worst rel {worst:.2e}, tol {RESUME_LOSS_RTOL:g}); warm step median "
              f"{statistics.median(warm):.2f} ms; all-reduced over the model row per step "
              f"{rm['bytes'][1]} bytes (without remat {tp['bytes'][1]}); peak memory "
              f"{rm['peak_mib']:.0f} MiB (without {tp['peak_mib']:.0f}); launches per step "
              f"{rm['counts'][0]}")
        check(all(c == expected_remat for c in rm["counts"]),
              f"rank {r}: TP remat launches per step {rm['counts']}, expected {expected_remat}")
        check(all(np.isfinite(rm["loss"])) and not any(rm["skipped"]),
              f"rank {r}: TP remat losses {rm['loss']} skipped {rm['skipped']}")
        check(worst <= RESUME_LOSS_RTOL, f"rank {r}: TP remat losses off by {worst}")
        check(len(set(rm["bytes"])) == 1 and rm["bytes"][0] > tp["bytes"][0],
              f"rank {r}: TP remat bytes per step {rm['bytes']} (without {tp['bytes'][0]})")
    check(ranks[0]["tp_bf16_remat"]["loss"] == ranks[1]["tp_bf16_remat"]["loss"],
          "the TP remat ranks' losses differ")

    steps = len(ranks[0]["train_tp_cli"]["steps"])
    for r, res in enumerate(ranks):
        tc = res["train_tp_cli"]
        check(all(c == expected for c in tc["steps"]) and len(tc["steps"]) == steps,
              f"rank {r}: TP train CLI launches per step {tc['steps']}")
        check(len(tc["requests"]) == (CORPUS_EVAL_N if r == 0 else 0)
              and all(c == expected_request for c in tc["requests"]),
              f"rank {r}: TP eval requests {tc['requests']}")
    run = os.path.join(tmp, "tp_run")
    logged = read_metrics(run)
    with open(os.path.join(run, "log.txt")) as f:
        log = f.read()
    step_times = [float(t) for t in re.findall(r"Time/step ([0-9.]+)", log)]
    mious = [m["miou"] for m in logged if "miou" in m]
    check(f"grid: dp 1 × tp {DP_WORLD}" in log, "the TP run logged no grid")
    check(sorted(os.listdir(run)) == ["best.json", "ckpt_best", "ckpt_epoch_0", "log.txt",
                                      "metrics.jsonl"], f"tp run wrote {os.listdir(run)}")
    check(len([m for m in logged if "loss" in m]) == steps == 2 and len(mious) == 1,
          f"tp run metrics {logged}")
    model_pt = os.path.join(run, "ckpt_epoch_0", "model.pt")
    saved = torch.load(model_pt, weights_only=True)
    want = {k: tuple(v.shape) for k, v in SegCLIP(ModelConfig()).state_dict().items()}
    check({k: tuple(v.shape) for k, v in saved.items()} == want,
          "the TP run's model.pt is not in the tp = 1 layout")
    del saved
    single = eval_zeroshot.main(["--dataset", "shapes", "--data-root",
                                 os.path.join(tmp, "shapes", "eval"), "--init-model",
                                 model_pt, "--output-dir", os.path.join(tmp, "tp_eval")])
    print(f"  cli.train --dist-* at train.tensor_parallelism={DP_WORLD} ({DP_WORLD} ranks, "
          f"dp1 × tp{DP_WORLD}), 1 epoch of phase 6's corpus on rgb ({smi}): {steps} steps "
          f"of 1 × {TRAIN_BATCH} on each rank, Time/step "
          f"{' '.join(f'{t * 1e3:.1f}' for t in step_times)} ms, the run "
          f"{ranks[0]['train_tp_cli']['seconds']:.1f} s; final loss "
          f"{ranks[0]['train_tp_cli']['final_loss']:.5f} on every rank: "
          f"{ranks[0]['train_tp_cli']['final_loss'] == ranks[1]['train_tp_cli']['final_loss']}"
          f"; model.pt in the tp = 1 layout ({len(want)} tensors); rank 0's eval mIoU "
          f"{mious[0]:.4f}; its model.pt in a one-process eval: mIoU {single['mIoU']:.4f}")
    check(ranks[0]["train_tp_cli"]["final_loss"] == ranks[1]["train_tp_cli"]["final_loss"],
          "the TP ranks' final losses differ")
    check(abs(single["mIoU"] - mious[0]) <= SHARDED_MIOU_TOL,
          f"the TP run's model.pt evaluates to {single['mIoU']}, the run logged {mious[0]}")
    return {k: sum(sum(c[k] for c in r["tp_bf16"]["counts"] + r["tp_bf16_remat"]["counts"])
                   + r["train_tp_cli"]["counts"][k] for r in ranks) for k in expected}


# Phase 10: the studies (segclip_tpu_torch/studies), each a subprocess on the
# card, on phase 6's best checkpoint and a holdout corpus made here: 16 eval
# images and one pair_eval image per color × shape pair (48). classprobe
# encodes the 16 in one batch, the margin probe decodes STUDY_MARGIN_LIMIT,
# the ipd study compares one image per decode call with STUDY_IPD, at
# float32 (SHARDED_MIN_AGREE of pixels equal and the mIoU within
# SHARDED_MIOU_TOL, phase 8's rule) and at bf16 (reported). The studies run
# as a user runs them, with no --device: on the card.
STUDY_CORPUS = ("--train-n", "8", "--eval-n", "16", "--pair-eval-n", "1")
STUDY_EVAL_N, STUDY_PAIRS = 16, 48
STUDY_BATCH, STUDY_MARGIN_LIMIT, STUDY_IPD = 16, 8, 4
STUDY_TIMEOUT_S = 300
STUDY_CKPT = "best_model.pt"        # phase 6's run A ckpt_best/model.pt, kept for phase 10
# Each report's keys, as the JAX scripts write them.
STUDY_KEYS = {
    "classprobe": {"ckpt", "n_images", "per_class"},
    "spatial_margin_probe": {"ckpt", "bg_thresh", "per_class"},
    "holdout_study": {"holdout_pairs", "standard_bank", "composed_bank",
                      "composed_per_pair_iou"},
    "eval_ipd_study": {"n_images", "seq", f"ipd{STUDY_IPD}", "d_miou", "flipped_pixel_frac"},
}
CLASSPROBE_KEYS = {"auc", "n_present", "mean_sim_present", "mean_sim_absent"}
MARGIN_KEYS = {"gt_pixels", "fg_argmax_is_own", "pred_background", "pred_own",
               "pred_other_fg", "mean_own_aff", "mean_best_other_fg_aff"}
IPD_KEYS = {"mIoU", "mAcc", "aAcc", "img_s"}


def study_worker(name: str, result: str, argv: list) -> int:
    """`python3 chip_smoke.py study <name> <result.json> <argv...>`: one
    study's main(argv) in this process, the launch counters over it and
    its report written to result.json."""
    from segclip_tpu_torch.kernels import build
    build.load()
    module = importlib.import_module(f"segclip_tpu_torch.studies.{name}")
    reset_counters()
    report = module.main(argv)
    with open(result, "w") as f:
        json.dump({"counts": read_counters(), "routes": read_routes(), "report": report}, f)
    return 0


def study_path_counts(cfg, banks: int, encodes: int) -> dict:
    """Launches of `banks` text banks (one text-tower call each) and
    `encodes` eval image encodes (layers0, the cross blocks and the group
    stage; one eval grouping each): rows 1 and 3 only."""
    return {"attention_fwd": banks * cfg.transformer_layers
            + encodes * (cfg.vision_layers + cfg.cross_layer),
            "attention_bwd": 0, "group_assign": encodes, "group_assign_st": 0,
            "plain_route": 0}


def finite(x) -> bool:
    return isinstance(x, (int, float)) and bool(np.isfinite(x))


def check_report(name: str, report: dict) -> None:
    """The script's keys, and every number finite where the script's would
    be (an AUC and a mean over the images with, or without, a class are
    NaN when none has it, or all do; an IoU is None where the class is
    neither predicted nor present)."""
    check(set(report) == STUDY_KEYS[name], f"{name}: keys {sorted(report)}")
    if name == "classprobe":
        n = report["n_images"]
        check(n == STUDY_EVAL_N and len(report["per_class"]) == 6, f"classprobe: {report}")
        for cls, r in report["per_class"].items():
            check(set(r) == CLASSPROBE_KEYS, f"classprobe {cls}: keys {sorted(r)}")
            mixed = 0 < r["n_present"] < n
            check(finite(r["auc"]) == mixed, f"classprobe {cls}: auc {r['auc']}")
            check(finite(r["mean_sim_present"]) == (r["n_present"] > 0)
                  and finite(r["mean_sim_absent"]) == (r["n_present"] < n),
                  f"classprobe {cls}: {r}")
    elif name == "spatial_margin_probe":
        check(finite(report["bg_thresh"]) and report["per_class"], f"margin probe: {report}")
        for cls, r in report["per_class"].items():
            check(set(r) == MARGIN_KEYS and all(finite(v) for v in r.values())
                  and r["gt_pixels"] > 0, f"margin probe {cls}: {r}")
            check(abs(r["pred_background"] + r["pred_own"] + r["pred_other_fg"] - 1) <= 2e-4,
                  f"margin probe {cls}: shares do not sum to 1: {r}")
    elif name == "holdout_study":
        check(len(report["holdout_pairs"]) > 0
              and len(report["composed_per_pair_iou"]) == STUDY_PAIRS, f"holdout: {report}")
        for bank in ("standard_bank", "composed_bank"):
            check(set(report[bank]) == {"held_out", "seen"}, f"holdout {bank}")
            for split, r in report[bank].items():
                check(finite(r["mIoU"]) and finite(r["mAcc"]), f"holdout {bank} {split}: {r}")
                check(all(v is None or finite(v) for v in (r.get("per_class") or {}).values()),
                      f"holdout {bank} {split}: {r}")
        check(all(v is None or finite(v) for v in report["composed_per_pair_iou"].values()),
              "holdout: per-pair IoU")
    else:
        for path in ("seq", f"ipd{STUDY_IPD}"):
            check(set(report[path]) == IPD_KEYS and all(finite(v) for v in report[path].values()),
                  f"ipd {path}: {report[path]}")
        check(report["n_images"] == STUDY_EVAL_N and finite(report["d_miou"])
              and finite(report["flipped_pixel_frac"]), f"ipd: {report}")


def host_stage_table(tmp: str) -> None:
    """The end of phase 10: `python -m segclip_tpu_torch.studies.host_stage_bench`
    on phase 6's corpus, as a user runs it; its table printed."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "segclip_tpu_torch.studies.host_stage_bench",
                           os.path.join(tmp, "shapes"), str(TRAIN_BATCH)],
                          capture_output=True, text=True, timeout=STUDY_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        print(f"  host_stage_bench exited {proc.returncode}:\n{proc.stderr[-6000:]}")
    check(proc.returncode == 0, f"host_stage_bench exited {proc.returncode}")
    print(f"  studies.host_stage_bench on phase 6's corpus, {TRAIN_BATCH} samples, one "
          f"process on the host's CPU ({time.perf_counter() - t0:.1f} s):")
    for line in proc.stdout.splitlines():
        print(f"    {line}")
    check(sum("ms/sample" in line for line in proc.stdout.splitlines()) == 11,
          "host_stage_bench printed another table")


def phase_studies(smi: str, tmp: str) -> dict:
    """Phase 10: the four studies, each run as a subprocess on the card
    (this script's `study` mode) on phase 6's best checkpoint. Returns the
    launch counts of all of them."""
    from segclip_tpu_torch.cli import prepare_data
    from segclip_tpu_torch.config import ModelConfig

    t_phase = time.perf_counter()
    cfg = ModelConfig()
    ckpt, corpus = os.path.join(tmp, STUDY_CKPT), os.path.join(tmp, "holdout")
    prepare_data.main(["shapes", "--out-dir", corpus, "--holdout", *STUDY_CORPUS])
    eval_root = os.path.join(corpus, "eval")
    ipd_counts = study_path_counts(cfg, 1, 2 * STUDY_EVAL_N + 2 * -(-STUDY_EVAL_N // STUDY_IPD))
    runs = (
        ("classprobe", ["--ckpt", ckpt, "--data-root", corpus, "--batch", str(STUDY_BATCH)],
         study_path_counts(cfg, 1, -(-STUDY_EVAL_N // STUDY_BATCH))),
        ("spatial_margin_probe", ["--ckpt", ckpt, "--data-root", eval_root, "--limit",
                                  str(STUDY_MARGIN_LIMIT)],
         study_path_counts(cfg, 1, STUDY_MARGIN_LIMIT)),
        ("holdout_study", ["--ckpt", ckpt, "--data-root", corpus],
         study_path_counts(cfg, 2, 2 * STUDY_PAIRS)),
    ) + tuple(("eval_ipd_study", ["--ckpt", ckpt, "--data-root", eval_root, "--ipd",
                                  str(STUDY_IPD), "--dtype", dtype], ipd_counts)
              for dtype in ("float32", "bfloat16"))
    print(f"phase 10: the studies, each a subprocess on the card ({smi}), on phase 6's best "
          f"checkpoint; corpus prepare_data shapes --holdout {' '.join(STUDY_CORPUS)} "
          f"({STUDY_EVAL_N} eval images, {STUDY_PAIRS} pair images) in "
          f"{time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    total = {}
    for i, (name, argv, expected) in enumerate(runs):
        result = os.path.join(tmp, f"study{i}.json")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "study", name,
                               result, *argv], capture_output=True, text=True,
                              timeout=STUDY_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            print(f"  {name} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                  f"{proc.stderr[-6000:]}")
        check(proc.returncode == 0, f"study {name} exited {proc.returncode}")
        with open(result) as f:
            out = json.load(f)
        report, counts = out["report"], out["counts"]
        add_routes(ROUTES_ELSEWHERE, out["routes"])
        check_report(name, report)
        notes = [line for line in proc.stdout.splitlines()
                 if line.startswith(("device ", f"{name}:"))]
        print(f"  {' '.join([name] + argv[4:])}: wall {wall:.1f} s (process start, model load "
              f"and run); launches {counts}; " + "; ".join(notes))
        check(counts == expected, f"study {name}: launches {counts}, expected {expected}")
        if name == "classprobe":
            print("    pooled AUC per class: " + ", ".join(
                f"{c} {r['auc']}" for c, r in report["per_class"].items()))
        elif name == "spatial_margin_probe":
            print("    own-class affinity / best other: " + ", ".join(
                f"{c} {r['mean_own_aff']}/{r['mean_best_other_fg_aff']}"
                for c, r in report["per_class"].items()))
        elif name == "holdout_study":
            print("    mIoU held out / seen: standard bank " + " / ".join(
                f"{report['standard_bank'][k]['mIoU']:.4f}" for k in ("held_out", "seen"))
                + ", composed bank " + " / ".join(
                f"{report['composed_bank'][k]['mIoU']:.4f}" for k in ("held_out", "seen")))
        else:
            ipd = report[f"ipd{STUDY_IPD}"]
            dtype = argv[argv.index("--dtype") + 1]
            print(f"    {dtype}: one image per call {report['seq']['img_s']} img/s, "
                  f"{STUDY_IPD} per call {ipd['img_s']} img/s; mIoU {report['seq']['mIoU']:.4f} "
                  f"/ {ipd['mIoU']:.4f} (d_miou {report['d_miou']}); flipped pixel share "
                  f"{report['flipped_pixel_frac']}")
            if dtype == "float32":
                check(1 - report["flipped_pixel_frac"] >= SHARDED_MIN_AGREE,
                      f"ipd float32: {report['flipped_pixel_frac']} of pixels flip")
                check(abs(report["d_miou"]) <= SHARDED_MIOU_TOL,
                      f"ipd float32: mIoU off by {report['d_miou']}")
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n
    host_stage_table(tmp)
    print(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s; launches of the studies "
          f"{total}")
    return total


def phase_transports(dev, smi: str, batches: dict) -> None:
    """Phase 11: the three transports on phase 6's first B = 96 batch of
    each: host→device bytes and copy time; yuv420_to_rgb with the step's
    normalisation and crop_resize_batch, card against CPU, and their
    device time per call beside the bound."""
    from segclip_tpu_torch.config import ModelConfig
    from segclip_tpu_torch.data.transforms import CLIP_STD
    from segclip_tpu_torch.ops.device_aug import crop_resize_batch, yuv420_to_rgb
    from segclip_tpu_torch.ops.kernels.bounds import (bound_ms, crop_resize_work,
                                                      yuv420_to_rgb_work)
    from segclip_tpu_torch.parallel.prefetch import to_device
    from segclip_tpu_torch.train.step import normalize_images

    res = ModelConfig().image_resolution
    print(f"phase 11: the transports on phase 6's B = {TRAIN_BATCH} batches ({smi})")
    image_bytes = {"rgb": TRAIN_BATCH * res * res * 3,
                   "yuv420": TRAIN_BATCH * (res * res + 2 * (res // 2) ** 2),
                   "device_aug": TRAIN_BATCH * res * 2 * res * 3}
    for transport, batch in batches.items():
        images = sum(v.nbytes for k, v in batch.items()
                     if k.startswith("image") and k != "image_seg")
        total = sum(v.nbytes for v in batch.values())
        copy_ms = statistics.median(timed(lambda: to_device(batch, dev))[1] for _ in range(7))
        print(f"  {transport}: host→device {total} B per batch, {images} B of them image "
              f"fields ({', '.join(f'{k} {tuple(v.shape)} {v.dtype}' for k, v in batch.items())}"
              f"); to_device (pin, copy, widen) median {copy_ms:.3f} ms")
        expected = image_bytes[transport]
        if transport == "device_aug":
            expected += TRAIN_BATCH * (4 * 4 + 1)          # int32 windows, uint8 flags
        check(images == expected, f"{transport}: {images} image bytes, expected {expected}")

    yb = batches["yuv420"]
    planes = {k: torch.from_numpy(yb[k]) for k in ("image_y", "image_cbcr")}
    on_card = {k: v.to(dev) for k, v in planes.items()}
    rgb_cpu = yuv420_to_rgb(planes["image_y"], planes["image_cbcr"])
    rgb_card = yuv420_to_rgb(on_card["image_y"], on_card["image_cbcr"]).cpu()
    std = torch.tensor(CLIP_STD) * 255.0
    norm_cpu = normalize_images(planes, res)["image"]
    norm_card = normalize_images(on_card, res)["image"].cpu()
    err = (rgb_card - rgb_cpu).abs().max().item()
    err_norm = ((norm_card - norm_cpu).abs() * std).max().item()
    ms = call_ms(lambda: normalize_images(on_card, res))
    bound, by = bound_ms(*yuv420_to_rgb_work(TRAIN_BATCH, res, res), torch.float32)
    print(f"  yuv420_to_rgb + normalisation, {TRAIN_BATCH}×{res}², card vs CPU: max |Δ| "
          f"{err:.3e} (RGB), {err_norm:.3e} (normalised, on the [0, 255] scale; tol "
          f"{YUV_TOL:g}); {ms:.4f} ms per call (CUDA events), bound {bound:.4f} ms ({by}), "
          f"{bound / ms:.1%} of it")
    check(torch.isfinite(norm_card).all() and tuple(norm_card.shape) == (TRAIN_BATCH, res,
                                                                          res, 3),
          f"yuv420 normalised {tuple(norm_card.shape)}")
    check(err <= YUV_TOL and err_norm <= YUV_TOL, f"yuv420_to_rgb card vs CPU {err}, {err_norm}")

    db = batches["device_aug"]
    # as the prefetch hands them over: int32 windows widened to int64
    args = [torch.from_numpy(db["image"]), torch.from_numpy(db["image_window"]).long(),
            torch.from_numpy(db["image_transposed"])]
    n_tall = int(args[2].sum())
    crop_cpu = crop_resize_batch(*args, res)
    args_card = [a.to(dev) for a in args]
    crop_card = crop_resize_batch(*args_card, res).cpu()
    diff = (crop_card - crop_cpu).abs()
    share = (diff > 0).float().mean().item()
    ms = call_ms(lambda: crop_resize_batch(*args_card, res), reps=20)
    ms_norm = call_ms(lambda: normalize_images(
        {"image": args_card[0], "image_window": args_card[1],
         "image_transposed": args_card[2]}, res), reps=20)
    bound, by = bound_ms(*crop_resize_work(TRAIN_BATCH - n_tall, n_tall, res, 2 * res, res),
                         torch.float32)
    print(f"  crop_resize_batch, {TRAIN_BATCH} canvases {res}×{2 * res} → {res}² "
          f"({TRAIN_BATCH - n_tall} wide, {n_tall} transposed), card vs CPU: max |Δ| "
          f"{diff.max().item():g} uint8 levels, {share:.3e} of values differ (tol 1 level on "
          f"≤ {CROP_SHARE:g}); {ms:.4f} ms per call, {ms_norm:.4f} with the normalisation "
          f"(CUDA events); bound {bound:.4f} ms ({by}: float32 products of the order each "
          f"sample needs, where the call computes both), {bound / ms:.1%} of it")
    check(0 < n_tall < TRAIN_BATCH, f"{n_tall} transposed samples: no mix")
    check(diff.max().item() <= 1.0 and share <= CROP_SHARE,
          f"crop_resize_batch card vs CPU: {diff.max().item()} levels on {share} of values")


class ShapeProbe:
    """Records the shapes each kernel wrapper is called at, for the length
    of a `with` block: attention (B, Lq, Lk, heads) and the Gumbel grouping
    (N, G, L, D)."""

    def __enter__(self):
        from segclip_tpu_torch.ops.kernels import attention, grouping
        self.attn, self.gumbel = set(), set()
        self.saved = attention.attention_fwd, grouping.group_assign_fwd
        fwd, group = self.saved
        probe = self

        def attention_fwd(q, k, v, *args, **kw):
            probe.attn.add((q.shape[0], q.shape[1], k.shape[1], q.shape[2] // 64))
            return fwd(q, k, v, *args, **kw)

        def group_assign_fwd(q, k, v, noise=None, tau=1.0):
            if noise is not None:
                probe.gumbel.add((q.shape[0], q.shape[1], k.shape[1], q.shape[2]))
            return group(q, k, v, noise, tau)

        attention.attention_fwd, grouping.group_assign_fwd = attention_fwd, group_assign_fwd
        return self

    def __exit__(self, *exc):
        from segclip_tpu_torch.ops.kernels import attention, grouping
        attention.attention_fwd, grouping.group_assign_fwd = self.saved


def train_run(dev, name: str, mcfg, b: int, steps: int, keep: bool = False) -> dict:
    """1 + `steps` steps of `make_train_step` (phase 4's optimizer settings)
    at `mcfg` (bf16, or float32 where it says so) on phase 4's synthetic
    batch at size b: the losses,
    each step's launches and time, the peak memory (and what earlier phases
    hold), the first step's gradients before the optimizer, and, with
    `keep`, the step itself for the profile. The first step's kernel shapes
    must be among phase 1's."""
    from segclip_tpu_torch.config import Config
    from segclip_tpu_torch.models.segclip import init_segclip
    from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step

    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev) / 2 ** 20
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = Config(model=mcfg)
    model = init_segclip(mcfg, seed=0, device=dev)
    step = make_train_step(model, create_optimizer(model, cfg, t_total=100), cfg)
    state = TrainState(step=0, seed=0)
    batch = synthetic_batch(b, mcfg, 0, dev)
    out = {"loss": [], "skipped": [], "counts": [], "ms": [], "routes": []}
    for i in range(1 + steps):
        reset_counters()
        routes = read_routes()
        with ShapeProbe() as shapes:
            metrics, ms = timed(lambda: step(state, batch))
        out["counts"].append(read_counters())
        out["routes"].append({k: n - routes[k] for k, n in read_routes().items()})
        out["loss"].append(float(metrics["loss"]))
        out["skipped"].append(float(metrics["skipped_nan"]))
        out["ms"].append(ms)
        if i == 0:
            out["grads"] = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                            if p.grad is not None}
            attn, gumbel = step_shapes(name, mcfg, b)
            want_attn = {(c[1], c[2], c[3], c[4]) for c in attn}
            want_gumbel = {c[1:] for c in gumbel}
            check(shapes.attn == want_attn and shapes.gumbel == want_gumbel,
                  f"{name}: the step ran attention at {sorted(shapes.attn)} and the Gumbel "
                  f"grouping at {sorted(shapes.gumbel)}; phase 1 checked {sorted(want_attn)}, "
                  f"{sorted(want_gumbel)}")
    out["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    out["held_mib"] = held
    expected = train_path_counts(mcfg)
    check(all(c == expected for c in out["counts"]),
          f"{name}: launches per step {out['counts']}, expected {expected}")
    check(all(np.isfinite(out["loss"])) and not any(out["skipped"]),
          f"{name}: losses {out['loss']}, skipped {out['skipped']}")
    lks = [c[3] for c in step_shapes(name, mcfg, b)[0]]
    long_rows = [lk for lk in lks if lk > 256]
    if mcfg.compute_dtype == "float32":   # the TF32x3 kernels, the long backward past 256 keys
        check(all(r["tf32x3"] > 0 and r["bwd_tf32x3"] > 0 and (r["bwd_tf32x3_long"] > 0)
                  == bool(long_rows) and r["one_pass"] == r["cluster"] == r["long"]
                  == r["two_pass"] == r["bwd_one_pass"] == r["bwd_cluster"] == r["bwd_long"]
                  == r["bwd_two_pass"] == 0 for r in out["routes"]),
              f"{name}: attention by route per step {out['routes']}; rows of {long_rows} keys "
              "must take the TF32x3 long backward, every other float32 call the TF32x3 kernels")
    else:                 # bf16: the cluster kernels to 1024 keys, the long kernels past it
        cluster = any(256 < lk <= 1024 for lk in lks)
        longer = any(lk > 1024 for lk in lks)
        check(all((r["cluster"] > 0) == (r["bwd_cluster"] > 0) == cluster
                  and (r["long"] > 0) == (r["bwd_long"] > 0) == longer
                  and r["two_pass"] == r["bwd_two_pass"] == r["tf32x3"] == r["bwd_tf32x3"]
                  == r["bwd_tf32x3_long"] == 0 for r in out["routes"]),
              f"{name}: attention by route per step {out['routes']}; rows of {long_rows} keys "
              "must take the cluster kernels (to 1024 keys) and the long kernels (past it)")
    if keep:
        out["step"] = lambda: step(state, batch)
    return out


def report_run(name: str, b: int, remat: bool, run: dict) -> None:
    warm = sorted(run["ms"][1:])
    med = statistics.median(warm)
    print(f"  {name} B={b} {'with' if remat else 'without'} remat: losses "
          f"{' '.join(f'{v:.5f}' for v in run['loss'])}; warm step median {med:.2f} ms "
          f"(min {warm[0]:.2f}, max {warm[-1]:.2f}, {len(warm)} steps), "
          f"{b * 1e3 / med:.1f} img/s; peak {run['peak_mib']:.0f} MiB ({run['held_mib']:.0f} "
          f"of it held by earlier phases); launches per step {run['counts'][0]}, attention by "
          f"route {run['routes'][0]}")


def phase_remat(dev, smi: str) -> tuple:
    """Phase 12: ModelConfig.remat and the JAX package's memory-bound training
    configurations, bf16 from seeded inits (the remat runs of phase 5 and of
    phase 9's ranks print under this phase's name): ViT-B/16 at B = 96 with
    and without remat (gradients before the optimizer compared), at B = 256
    both ways, ViT-L/14 at B = 32 both ways, ViT-B/16 at 448 px, B = 24,
    and B = 512 with remat, kept for the profile; one float32 ViT-L/14 step
    at B = 2 (L14_F32_BATCH), whose cross blocks' 264 keys are past the
    TF32x3 backward's limit and take the TF32x3 long backward; and a cold
    and a warm step of each of "448_f32" (float32 448 px, B = 2: its 784 and
    792 take the TF32x3 long backward) and "672" (bf16 672 px, B = 4: its
    1764 and 1772 take the long kernels both ways). Returns the launch
    counts by path, the B = 512 step, the 448 px step and the long
    backwards' launches by step ({"l14_f32", "448_f32": TF32x3 long; "672":
    long}) and the 672 px step's long forwards ("672_fwd")."""
    from segclip_tpu_torch.config import ModelConfig

    t_phase = time.perf_counter()
    total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 20
    print(f"phase 12: remat and the large training configurations ({smi}; "
          f"{total:.0f} MiB on the card)")
    counts = {}

    def add(path, run):
        for c in run["counts"]:
            for k, n in c.items():
                counts.setdefault(path, {}).setdefault(k, 0)
                counts[path][k] += n

    runs = {}
    for remat in (False, True):
        runs[remat] = train_run(dev, "b96", ModelConfig(remat=remat), TRAIN_BATCH, TRAIN_STEPS)
        report_run("ViT-B/16", TRAIN_BATCH, remat, runs[remat])
        add("train_remat", runs[remat])
    plain, remat = runs[False], runs[True]
    worst_loss = max(abs(a - b) / abs(b) for a, b in zip(remat["loss"], plain["loss"]))
    same = plain["grads"].keys() == remat["grads"].keys()
    bitwise = same and all(torch.equal(g, remat["grads"][n]) for n, g in plain["grads"].items())
    worst_grad = max(((remat["grads"][n] - g).float().abs().max().item()
                      / max(g.float().abs().max().item(), 1e-30), n)
                     for n, g in plain["grads"].items()) if same else (float("inf"), "keys")
    print(f"  B={TRAIN_BATCH}, remat against none: losses bit for bit "
          f"{remat['loss'] == plain['loss']} (worst rel {worst_loss:.2e}, tol "
          f"{RESUME_LOSS_RTOL:g}); the first step's gradients before the optimizer bit for bit "
          f"{bitwise} on {len(plain['grads'])} tensors (worst {worst_grad[0]:.2e}·max|g| at "
          f"{worst_grad[1]}, tol {REMAT_GRAD_RTOL:g}); peak {plain['peak_mib']:.0f} → "
          f"{remat['peak_mib']:.0f} MiB, warm median {statistics.median(plain['ms'][1:]):.2f} → "
          f"{statistics.median(remat['ms'][1:]):.2f} ms")
    check(worst_loss <= RESUME_LOSS_RTOL, f"remat moves the losses by {worst_loss}")
    check(worst_grad[0] <= REMAT_GRAD_RTOL, f"remat moves the gradient of {worst_grad[1]} "
                                            f"by {worst_grad[0]}·max|g|")
    check(remat["peak_mib"] < plain["peak_mib"], "remat does not lower the peak")
    own = {TRAIN_BATCH: plain["peak_mib"] - plain["held_mib"]}
    del runs, plain, remat

    large = {}
    for name, remats in (("b256", (False, True)), ("l14", (False, True)), ("448", (False,)),
                         ("b512", (True,))):
        arch, overrides, b = LARGE_CONFIGS[name]
        for remat in remats:
            run = train_run(dev, name, large_config(name, remat), b, LARGE_STEPS,
                            keep=name in ("b512", "448"))
            report_run(f"{arch}{' 448 px' if overrides else ''}", b, remat, run)
            add({"b256": "train_remat", "b512": "train_b512", "l14": "train_l14",
                 "448": "train_448"}[name], run)
            if name in ("l14", "448"):
                check(run["loss"][-1] < run["loss"][0],
                      f"{name}: the loss does not fall over the steps: {run['loss']}")
            run.pop("grads")
            large[(name, remat)] = run
    for name in ("b256", "l14"):
        a, r = large[(name, False)], large[(name, True)]
        worst = max(abs(x - y) / abs(y) for x, y in zip(r["loss"], a["loss"]))
        saved = 1 - (r["peak_mib"] - r["held_mib"]) / (a["peak_mib"] - a["held_mib"])
        print(f"  {name}, remat against none: losses bit for bit {r['loss'] == a['loss']} "
              f"(worst rel {worst:.2e}); peak {a['peak_mib']:.0f} → {r['peak_mib']:.0f} MiB "
              f"({saved:.1%} of the run's own memory saved); warm median "
              f"{statistics.median(a['ms'][1:]):.2f} → {statistics.median(r['ms'][1:]):.2f} ms")
        check(worst <= RESUME_LOSS_RTOL, f"{name}: remat moves the losses by {worst}")
        check(r["peak_mib"] < a["peak_mib"], f"{name}: remat does not lower the peak")
    b256 = large[("b256", False)]
    own[256] = b256["peak_mib"] - b256["held_mib"]
    b512 = large[("b512", True)]
    estimate = own[TRAIN_BATCH] + (own[256] - own[TRAIN_BATCH]) * (512 - TRAIN_BATCH) / (
        256 - TRAIN_BATCH)
    print(f"  B=512 with remat: peak {b512['peak_mib']:.0f} MiB of the card's {total:.0f}; "
          f"without remat it would need about {estimate:.0f} MiB of its own (linear in B "
          f"through the runs without remat at {TRAIN_BATCH} and 256: {own[TRAIN_BATCH]:.0f}, "
          f"{own[256]:.0f}), not run")
    check(b512["peak_mib"] < total, f"B=512 peaks at {b512['peak_mib']} MiB of {total}")
    f32 = train_run(dev, "l14 float32", l14_f32_config(), L14_F32_BATCH, 1)
    report_run("ViT-L/14 float32", L14_F32_BATCH, False, f32)
    add("train_l14_f32", f32)
    long_counts = {"l14_f32": sum(r["bwd_tf32x3_long"] for r in f32["routes"])}
    for name, label, key in (("448_f32", "ViT-B/16 448 px float32", "bwd_tf32x3_long"),
                             ("672", "ViT-B/16 672 px", "bwd_long")):
        b = LARGE_CONFIGS[name][2]
        run = train_run(dev, name, large_config(name, False), b, 1)
        report_run(label, b, False, run)
        add(f"train_{name}", run)
        long_counts[name] = sum(r[key] for r in run["routes"])
        if name == "672":                      # its 1764 and 1772 take the long forward too
            long_counts["672_fwd"] = sum(r["long"] for r in run["routes"])
    print(f"  phase 12's steps took {time.perf_counter() - t_phase:.1f} s")
    return counts, b512.pop("step"), large[("448", False)].pop("step"), long_counts


def runm_args(data: str, out: str) -> list:
    """scripts/runM_batch192.sh's command line for the port, at RUNM_EPOCHS
    epochs (one per call) and a log line per step."""
    return ["--datatype", "shapes", "--data-dir", data, "--batch-size", "192",
            "--epochs", str(RUNM_EPOCHS), "--lr", "4e-4", "--lower-lr", "4e-4",
            "--warmup-proportion", "0.1", "--use-seglabel", "--use-vision-mae-recon",
            "--eval-each-epoch", "--eval-data-root", os.path.join(data, "eval"),
            "--num-workers", "0", "--output-dir", out, "--do-resume", "--n-display", "1",
            "--opts", "eval.dataset=shapes", "model.gumbel_tau=3.0",
            "model.group_balance_weight=1.0", "model.remat=true", "train.keep_best=true",
            "train.epochs_per_run=1", "train.checkpoint_every=2"]


def phase_runm(smi: str) -> dict:
    """Phase 12, the end: run M's recipe through cli.train, as
    scripts/runM_batch192.sh runs it (B = 192, remat, one epoch per call,
    --do-resume), on a shapes corpus of RUNM_TRAIN_N scenes (two steps per
    epoch) made here, for RUNM_EPOCHS calls: finite losses, every step's
    and eval request's launches, model.pt in the tp = 1 layout evaluating
    to the logged mIoU. Returns the launch counts of the run."""
    from segclip_tpu_torch.cli import eval_zeroshot, prepare_data
    from segclip_tpu_torch.cli import train as train_cli
    from segclip_tpu_torch.config import ModelConfig
    from segclip_tpu_torch.models.segclip import SegCLIP

    cfg = ModelConfig(remat=True, gumbel_tau=3.0, group_balance_weight=1.0)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runm_") as tmp:
        data, out = os.path.join(tmp, "shapes"), os.path.join(tmp, "runM")
        prepare_data.main(["shapes", "--out-dir", data, "--train-n", str(RUNM_TRAIN_N),
                           "--eval-n", str(CORPUS_EVAL_N)])
        segments = []
        with CountingPath() as path:
            reset_counters()
            for _ in range(RUNM_EPOCHS):
                t0 = time.perf_counter()
                result = train_cli.main(runm_args(data, out))
                segments.append((result["epochs_run"], round(time.perf_counter() - t0, 1),
                                 sorted(d for d in os.listdir(out) if d != "log.txt")))
                del result
                torch.cuda.empty_cache()
            counts = read_counters()
        logged = read_metrics(out)
        losses = [m["loss"] for m in logged if "loss" in m]
        mious = [m["miou"] for m in logged if "miou" in m]
        step_times = log_step_times(out)
        model_pt = os.path.join(out, f"ckpt_epoch_{RUNM_EPOCHS - 1}", "model.pt")
        saved = torch.load(model_pt, weights_only=True)
        want = {k: tuple(v.shape) for k, v in SegCLIP(ModelConfig()).state_dict().items()}
        layout = {k: tuple(v.shape) for k, v in saved.items()} == want
        del saved
        single = eval_zeroshot.main(["--dataset", "shapes", "--data-root",
                                     os.path.join(data, "eval"), "--init-model", model_pt,
                                     "--output-dir", os.path.join(tmp, "runM_eval")])
    print(f"  run M through cli.train ({smi}): {' '.join(runm_args('D', 'O'))}, on "
          f"prepare_data shapes --train-n {RUNM_TRAIN_N} --eval-n {CORPUS_EVAL_N} "
          f"({2 * RUNM_TRAIN_N} samples), {RUNM_EPOCHS} calls: (epochs, s, what each left) "
          f"{segments}; losses {' '.join(f'{v:.5f}' for v in losses)}; Time/step "
          f"{' '.join(f'{t * 1e3:.1f}' for t in step_times)} ms; mIoU per epoch "
          f"{' '.join(f'{v:.4f}' for v in mious)}; model.pt in the tp = 1 layout: {layout}; "
          f"its one-process eval mIoU {single['mIoU']:.4f}; launches per step "
          f"{path.steps[0] if path.steps else None}; the run M part took "
          f"{time.perf_counter() - t_phase:.1f} s")
    steps = RUNM_EPOCHS * 2 * RUNM_TRAIN_N // 192
    check([n for n, _, _ in segments] == [1] * RUNM_EPOCHS, f"run M segments {segments}")
    check(segments[-1][2] == ["best.json", "ckpt_best"] + [
        f"ckpt_epoch_{e}" for e in range(RUNM_EPOCHS)] + ["metrics.jsonl"],
        f"run M wrote {segments[-1][2]}")
    check(len(losses) == steps == len(path.steps) and all(np.isfinite(losses)),
          f"run M losses {losses}, {len(path.steps)} steps")
    check(len(mious) == RUNM_EPOCHS and all(np.isfinite(mious)), f"run M mIoU lines {mious}")
    check(layout, "run M's model.pt is not in the tp = 1 layout")
    check(abs(single["mIoU"] - mious[-1]) <= SHARDED_MIOU_TOL,
          f"run M's model.pt evaluates to {single['mIoU']}, the run logged {mious[-1]}")
    check_cli_launches("run M", cfg, path, counts, RUNM_EPOCHS)
    return counts


def phase_b32(dev, smi: str, tmp: str, b16: dict) -> tuple:
    """Phase 13: ViT-B/32 (the preset `--clip-arch ViT-B/32` selects) from a
    seeded init, bf16: phase 2's eval requests (224×224 whole, 224×448 slide,
    a group map) with their launches and kernel shapes; phase 5's float32
    B = 2 step on the card against the CPU; 1 + TRAIN_STEPS steps at
    TRAIN_BATCH beside phase 4's ViT-B/16 (`b16`: its warm ms and peak);
    `cli.train --preset shapes-learnability --clip-arch ViT-B/32` for one
    epoch of phase 6's corpus (<tmp>/shapes) on the CLI's default transport
    with per-epoch eval on the card, its model.pt evaluating to the logged
    mIoU. Returns the launch counts by path and the B = 96 step."""
    from segclip_tpu_torch.cli import eval_zeroshot
    from segclip_tpu_torch.cli import train as train_cli
    from segclip_tpu_torch.evalseg.inference import ZeroShotSegmenter
    from segclip_tpu_torch.evalseg.text_bank import build_text_bank
    from segclip_tpu_torch.models.segclip import SegCLIP, init_segclip

    cfg = b32_config()
    t_phase = time.perf_counter()
    print(f"phase 13: ViT-B/32 ({smi}; patch {cfg.vision_patch_size}, "
          f"{cfg.grid_size}x{cfg.grid_size} patches at {cfg.image_resolution} px)")
    counts = {}
    model = init_segclip(cfg, seed=0, device=dev)
    rng = np.random.default_rng(13)
    img_224 = rng.standard_normal((224, 224, 3), dtype=np.float32)
    img_224x448 = rng.standard_normal((224, 448, 3), dtype=np.float32)
    reset_counters()
    bank = build_text_bank(model, VOC_CLASSES, "simple", cfg.context_length)
    seg = ZeroShotSegmenter(model, bank, with_bg=True, bg_thresh=VOC_BG_THRESH,
                            patch_size=cfg.vision_patch_size)
    requests = (
        ("224x224 whole", lambda: seg.predict(img_224, (224, 224), "whole"), (224, 224),
         len(VOC_CLASSES) + 1),
        ("224x448 slide (2 windows)", lambda: seg.predict(img_224x448, (224, 448), "slide"),
         (224, 448), len(VOC_CLASSES) + 1),
        ("224x224 group_map", lambda: seg.group_map(img_224), (224, 224), cfg.group_num))
    expected = eval_request_counts(cfg)
    checked = {(c[1], c[2], c[3], c[4]) for c in ATTN_CASES}
    for name, fn, shape, upper in requests:
        before = read_counters()
        with ShapeProbe() as shapes:
            pred, cold_ms = timed(fn)
        per_request = counter_delta(before)
        print(f"  eval {name}: cold {cold_ms:.1f} ms, labels {np.unique(pred).size} distinct; "
              f"launches {per_request}; attention shapes {sorted(shapes.attn)}")
        check(pred.shape == shape and pred.dtype == np.int32 and pred.min() >= 0
              and pred.max() < upper, f"ViT-B/32 {name}: {pred.shape} {pred.dtype}")
        check(per_request == expected, f"ViT-B/32 {name}: launches {per_request}, "
                                       f"expected {expected}")
        check(shapes.attn <= checked, f"ViT-B/32 {name}: attention at {shapes.attn - checked}, "
                                      "shapes phase 1 did not check")
    counts["eval_b32"] = read_counters()
    want = {k: 3 * n for k, n in expected.items()}
    want["attention_fwd"] += cfg.transformer_layers            # the text bank
    check(counts["eval_b32"] == want, f"ViT-B/32 eval path launches {counts['eval_b32']}, "
                                      f"expected {want}")
    for name, fn, _, _ in requests:                           # warm latency, uncounted
        warm = sorted(timed(fn)[1] for _ in range(5))
        print(f"  eval {name}: warm median {warm[2]:.2f} ms (min {warm[0]:.2f}, max "
              f"{warm[-1]:.2f}, 5 runs)")
    check(np.isfinite(seg.whole(img_224)).all(), "ViT-B/32: non-finite logits")

    phase_train_plain_self(dev, model, cfg, phase=13, remat=False)
    del model, seg, bank

    run = train_run(dev, "b32", cfg, TRAIN_BATCH, TRAIN_STEPS, keep=True)
    report_run(B32_ARCH, TRAIN_BATCH, False, run)
    med = statistics.median(run["ms"][1:])
    print(f"  beside phase 4's ViT-B/16 at B={TRAIN_BATCH}: {med:.2f} against "
          f"{b16['warm_ms']:.2f} ms per step, {TRAIN_BATCH * 1e3 / med:.1f} against "
          f"{TRAIN_BATCH * 1e3 / b16['warm_ms']:.1f} img/s; own peak "
          f"{run['peak_mib'] - run['held_mib']:.0f} MiB (ViT-B/16's peak {b16['peak_mib']:.0f})")
    counts["train_b32"] = {k: sum(c[k] for c in run["counts"]) for k in run["counts"][0]}
    b32_step = run.pop("step")
    del run

    data, out = os.path.join(tmp, "shapes"), os.path.join(tmp, "b32")
    argv = ["--preset", "shapes-learnability", "--clip-arch", B32_ARCH, "--data-dir", data,
            "--epochs", "1", "--num-workers", "0", "--n-display", "1", "--output-dir", out]
    with CountingPath() as path:
        reset_counters()
        t0 = time.perf_counter()
        result = train_cli.main(argv)
        run_s = time.perf_counter() - t0
        counts["train_cli_b32"] = read_counters()
    del result
    torch.cuda.empty_cache()
    logged = read_metrics(out)
    losses = [m["loss"] for m in logged if "loss" in m]
    mious = [m["miou"] for m in logged if "miou" in m]
    model_pt = os.path.join(out, "ckpt_epoch_0", "model.pt")
    saved = torch.load(model_pt, weights_only=True)
    want = {k: tuple(v.shape) for k, v in SegCLIP(cfg).state_dict().items()}
    layout = {k: tuple(v.shape) for k, v in saved.items()} == want
    del saved
    single = eval_zeroshot.main(["--dataset", "shapes", "--data-root",
                                 os.path.join(data, "eval"), "--init-model", model_pt,
                                 "--output-dir", os.path.join(tmp, "b32_eval")])
    print(f"  cli.train {' '.join(argv[:6])} --epochs 1 (yuv420, the CLI's default): "
          f"{run_s:.1f} s; losses {' '.join(f'{v:.5f}' for v in losses)}; Time/step "
          f"{' '.join(f'{t * 1e3:.1f}' for t in log_step_times(out))} ms; mIoU "
          f"{' '.join(f'{v:.4f}' for v in mious)}; model.pt of ViT-B/32's shapes: {layout}; "
          f"its one-process eval mIoU {single['mIoU']:.4f}; launches per step "
          f"{path.steps[0] if path.steps else None}")
    check(len(losses) == 2 == len(path.steps) and all(np.isfinite(losses)),
          f"ViT-B/32 CLI losses {losses}, {len(path.steps)} steps")
    check(len(mious) == 1 and np.isfinite(mious[0]), f"ViT-B/32 CLI mIoU lines {mious}")
    check(layout, "the ViT-B/32 run's model.pt is not of ViT-B/32's shapes")
    check(abs(single["mIoU"] - mious[-1]) <= SHARDED_MIOU_TOL,
          f"the ViT-B/32 model.pt evaluates to {single['mIoU']}, the run logged {mious[-1]}")
    check_cli_launches("ViT-B/32 run", cfg, path, counts["train_cli_b32"], 1)
    shutil.rmtree(out)
    print(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return counts, b32_step


def phase_drift(dev, smi: str) -> dict:
    """Phase 14: the JAX package's 12-step float32 trajectory replayed on the
    card from tests/fixtures/torch_drift.npz, TF32 off: every step's loss
    within DRIFT_RTOL of JAX's, its launches equal to the path's count and
    its kernel shapes among phase 1's. Returns the launches of the run."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    fixture = drift_fixture()
    cfg, ref = fixture["cfg"], fixture["losses"]
    run = drift_replay(dev, fixture)
    gaps = [abs(a - b) / abs(b) for a, b in zip(run["loss"], ref)]
    expected = train_path_counts(cfg.model)
    attn, gumbel = step_shapes("drift", cfg.model, fixture["batch"]["image"].shape[0])
    print(f"phase 14: the JAX package's 12-step trajectory on the card ({smi}; float32, TF32 "
          f"off, JAX's draws): losses {' '.join(f'{v:.6f}' for v in run['loss'])}; relative "
          f"gap to JAX's per step {' '.join(f'{g:.2e}' for g in gaps)} (worst {max(gaps):.2e}, "
          f"bound {DRIFT_RTOL:g}); launches per step {run['counts'][0]}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    check(len(run["loss"]) == len(ref) and max(gaps) <= DRIFT_RTOL,
          f"drift: the losses leave JAX's trajectory: gaps {gaps}")
    check(not any(run["skipped"]), f"drift: skipped steps {run['skipped']}")
    check(all(c == expected for c in run["counts"]),
          f"drift: launches per step {run['counts']}, expected {expected}")
    check(run["shapes"] == ({(c[1], c[2], c[3], c[4]) for c in attn}, {c[1:] for c in gumbel}),
          f"drift: kernel shapes {run['shapes']}, phase 1 checked {attn}, {gumbel}")
    return {"drift": {k: sum(c[k] for c in run["counts"]) for k in expected}}


def profile_step(name: str) -> int:
    """`python3 chip_smoke.py profile-step <LARGE_CONFIGS name, or l14_f32>`:
    1 + 3 warm steps of `make_train_step` at that configuration (no remat;
    "l14_f32" is phase 12's float32 ViT-L/14 at B = 2) on the synthetic
    batch, then one profiled step (device busy, idle share, the port's
    kernels). Uses only what the port had before the cluster kernels, so
    that the same script measures an older tree too."""
    from segclip_tpu_torch.config import Config
    from segclip_tpu_torch.kernels import build
    from segclip_tpu_torch.models.segclip import init_segclip
    from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    build.load()
    dev = torch.device("cuda")
    mcfg, b = ((l14_f32_config(), L14_F32_BATCH) if name == "l14_f32"
               else (large_config(name, False), LARGE_CONFIGS[name][2]))
    cfg = Config(model=mcfg)
    model = init_segclip(mcfg, seed=0, device=dev)
    step = make_train_step(model, create_optimizer(model, cfg, t_total=100), cfg)
    state, batch = TrainState(step=0, seed=0), synthetic_batch(b, mcfg, 0, dev)
    walls = [timed(lambda: step(state, batch))[1] for _ in range(1 + LARGE_STEPS)]
    print(f"{name} B={b}: step walls {' '.join(f'{w:.2f}' for w in walls)} ms (first cold)")
    print_profile(f"training step {name} B={b}", lambda: step(state, batch))
    return 0


def float32_paths() -> int:
    """`python3 chip_smoke.py float32-paths`: the float32 paths alone, as a
    user runs them, with nothing checked: phase 3's 224x224 whole request
    (warm median of 7 requests, then one profiled: device busy, the port's
    kernels), phase 8's eight images at SHARDED_PER_CALL per predict_batch
    call (img/s, median of 3 passes; slide windows as the VOC evaluator
    takes them), and phase 5's float32 step at B = 2 (3 warm steps, then one
    profiled), from ViT-B/16 seeded inits. Uses only what the port had
    before the TF32x3 kernel, so that the same script measures an older
    tree too."""
    from segclip_tpu_torch.cli.eval_zeroshot import build_segmenter
    from segclip_tpu_torch.config import Config, ModelConfig
    from segclip_tpu_torch.evalseg.datasets import DATASET_SPECS
    from segclip_tpu_torch.kernels import build
    from segclip_tpu_torch.models.segclip import init_segclip
    from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step
    from segclip_tpu_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    build.load()
    dev = resolve_device("cuda")                      # TF32 off
    cfg = ModelConfig(compute_dtype="float32")
    model = init_segclip(cfg, seed=0, device=dev).eval()
    seg = build_segmenter(model, cfg, DATASET_SPECS["voc"])
    rng = np.random.default_rng(1)
    img = rng.standard_normal((224, 224, 3), dtype=np.float32)
    with torch.no_grad():
        walls = sorted(timed(lambda: seg.predict(img, (224, 224), "whole"))[1] for _ in range(8))[:7]
        print(f"float32 224x224 whole request: warm median {walls[3]:.2f} ms (min {walls[0]:.2f}, "
              f"max {walls[-1]:.2f})")
        print_profile("float32 224x224 whole request", lambda: seg.predict(img, (224, 224), "whole"))
        images = [rng.standard_normal((h, w, 3), dtype=np.float32) for h, w in SHARDED_IMAGES]

        def batched():
            for i in range(0, len(images), SHARDED_PER_CALL):
                seg.predict_batch(images[i:i + SHARDED_PER_CALL], SHARDED_IMAGES[i:i + SHARDED_PER_CALL])
        batched()
        passes = sorted(timed(batched)[1] for _ in range(3))
        print(f"float32 eight images at {SHARDED_PER_CALL} per decode call: "
              f"{len(images) * 1e3 / passes[1]:.1f} img/s (median of 3 passes, "
              f"{' '.join(f'{x:.1f}' for x in passes)} ms)")
        print_profile(f"float32 eight images at {SHARDED_PER_CALL} per call", batched)
    del seg, model
    train_cfg = Config(model=cfg)
    model = init_segclip(cfg, seed=0, device=dev)
    step = make_train_step(model, create_optimizer(model, train_cfg, t_total=100), train_cfg)
    state, batch = TrainState(step=0, seed=0), synthetic_batch(2, cfg, 0, dev)
    walls = [timed(lambda: step(state, batch))[1] for _ in range(4)]
    print(f"float32 step B=2: walls {' '.join(f'{w:.2f}' for w in walls)} ms (first cold)")
    print_profile("float32 training step B=2", lambda: step(state, batch))
    return 0


def long_requests() -> int:
    """`python3 chip_smoke.py long-requests`: phase 2's whole requests past
    1024 patches alone, as a user runs them, with nothing checked: 448x672
    (1176 patches) and 224x2048 (1792), each in bfloat16 and in float32 from
    a ViT-B/16 seeded init, the warm median of 7 requests after a cold one,
    then one profiled (device busy, idle share, the port's kernels). Uses
    only what the port had before the long kernel, so that the same script
    measures an older tree too."""
    from segclip_tpu_torch.cli.eval_zeroshot import build_segmenter
    from segclip_tpu_torch.config import ModelConfig
    from segclip_tpu_torch.evalseg.datasets import DATASET_SPECS
    from segclip_tpu_torch.kernels import build
    from segclip_tpu_torch.models.segclip import init_segclip
    from segclip_tpu_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    build.load()
    dev = resolve_device("cuda")                      # TF32 off
    rng = np.random.default_rng(0)
    images = {shape: rng.standard_normal((*shape, 3), dtype=np.float32)
              for shape in ((448, 672), (224, 2048))}
    for dtype in ("bfloat16", "float32"):
        cfg = ModelConfig(compute_dtype=dtype)
        seg = build_segmenter(init_segclip(cfg, seed=0, device=dev).eval(), cfg,
                              DATASET_SPECS["voc"])
        with torch.no_grad():
            for (h, w), img in images.items():
                def request():
                    return seg.predict(img, (h, w), "whole")
                walls = sorted(timed(request)[1] for _ in range(8))[:7]
                print(f"{dtype} {h}x{w} whole request: warm median {walls[3]:.2f} ms (min "
                      f"{walls[0]:.2f}, max {walls[-1]:.2f})")
                print_profile(f"{dtype} {h}x{w} whole request", request)
        del seg
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    if sys.argv[1:2] == ["study"]:                   # phase 10's subprocesses
        return study_worker(sys.argv[2], sys.argv[3], sys.argv[4:])
    if sys.argv[1:2] == ["long-requests"]:
        return long_requests()
    if sys.argv[1:2] == ["profile-step"]:
        return profile_step(sys.argv[2])
    if sys.argv[1:2] == ["float32-paths"]:
        return float32_paths()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from segclip_tpu_torch.kernels import build
    from segclip_tpu_torch.config import ModelConfig
    from segclip_tpu_torch.utils.device import resolve_device

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    smi = smi.stdout.strip().splitlines()[0]
    print(smi)
    dev = resolve_device("cuda")
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}")
    # without cv2, evalseg/datasets.keep_ratio_resize resizes eval images
    # with PIL BILINEAR instead of the mmseg kernel (cv2 INTER_LINEAR)
    has_cv2 = importlib.util.find_spec("cv2") is not None
    print(f"cv2 importable: {has_cv2} (eval image resize: "
          f"{'cv2 INTER_LINEAR, as mmseg' if has_cv2 else 'PIL BILINEAR fallback'})")

    t0 = time.perf_counter()
    build.load()
    print(f"kernel build + load: {time.perf_counter() - t0:.1f} s")
    spilled = print_ptxas(build.build_log())
    no_spill = {k: n for k, n in spilled.items()
                if k.startswith(("attention_fwd_tf32x3_kernel", "attention_bwd_tf32x3_kernel",
                                 "attention_fwd_long_kernel", "attention_bwd_long_",
                                 "attention_bwd_tf32x3_long_"))}
    check(len(no_spill) == 12 and not any(no_spill.values()),
          f"the TF32x3 and long kernels' instances and their spill bytes: {no_spill}")
    hmma = tensor_core_counts(build.build())

    summary, timings = phase_kernels(dev)
    # the main path from here: the forward's launches by route, per phase
    reset_routes()
    marks = [("start", dict(ROUTES_ELSEWHERE))]

    def mark(path: str) -> None:
        now = read_routes()
        add_routes(now, ROUTES_ELSEWHERE)
        marks.append((path, now))

    cfg = ModelConfig()
    (model, seg, requests, eval_counts, per_request, cluster_per_request,
     eval_long) = phase_slice(dev, cfg)
    mark("eval")
    phase_plain_self(dev, model, cfg)
    mark("eval_f32")
    train_model, step, state, batch, train_counts, warm_step_ms, train_peak = phase_train(dev)
    mark("train")
    per_step = train_path_counts(cfg)
    phase_train_plain_self(dev, train_model)
    mark("train_f32")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cli_counts, cli_c_counts, transport_batches = phase_train_cli(smi, warm_step_ms, tmp)
        mark("train_cli")
        demo_counts, model_path = phase_ingest_demo(dev, model, tmp)
        mark("demo")
        sharded_counts, eval_one, voc = phase_sharded_eval(dev, model, cfg, tmp, model_path)
        mark("eval_sharded")
        dp_counts, dp_eval_counts, tp_counts = phase_data_parallel(
            dev, tmp, smi, warm_step_ms, voc, model_path, eval_one)
        mark("train_dp_tp")
        studies_counts = phase_studies(smi, tmp)
        mark("studies")
        b32_counts, b32_step = phase_b32(dev, smi, tmp, {"warm_ms": warm_step_ms,
                                                         "peak_mib": train_peak})
        mark("b32")
    phase_transports(dev, smi, transport_batches)
    remat_counts, b512_step, px448_step, long_counts = phase_remat(dev, smi)
    mark("remat_large")
    runm_counts = phase_runm(smi)
    mark("train_cli_runM")
    drift_counts = phase_drift(dev, smi)
    mark("drift")
    routes = {path: {k: n - prev[k] for k, n in now.items()}
              for (_, prev), (path, now) in zip(marks, marks[1:])}
    print("launches by route on the main path, per phase (forward; backward): " + "; ".join(
        f"{path} {r['one_pass']} one-pass / {r['cluster']} cluster / {r['long']} long / "
        f"{r['tf32x3']} tf32x3 / {r['two_pass']} two-pass; {r['bwd_one_pass']} one-pass / "
        f"{r['bwd_cluster']} cluster / {r['bwd_long']} long / {r['bwd_tf32x3']} tf32x3 / "
        f"{r['bwd_tf32x3_long']} tf32x3 long / {r['bwd_two_pass']} two-pass"
        for path, r in routes.items()))
    for path in ("eval", "remat_large"):      # the 224x336 request; 448 px and ViT-L/14
        check(routes[path]["cluster"] > 0, f"{path}: no forward on the cluster kernel")
    check(routes["remat_large"]["bwd_cluster"] > 0, "remat_large: no backward on the cluster kernel")
    for path in ("eval_f32", "train_f32", "drift"):   # float32 only: the TF32x3 kernels
        r = routes[path]
        check(r["tf32x3"] > 0 and r["two_pass"] == r["one_pass"] == r["cluster"] == r["long"]
              == r["bwd_one_pass"] == r["bwd_cluster"] == r["bwd_long"] == r["bwd_tf32x3_long"]
              == r["bwd_two_pass"] == 0 and (r["bwd_tf32x3"] > 0) == (path != "eval_f32"),
              f"{path} (float32): launches by route {r}")
    for path in ("eval_sharded", "train_dp_tp", "studies", "b32"):     # their float32 parts
        check(routes[path]["tf32x3"] > 0, f"{path}: its float32 forwards did not take the "
              f"TF32x3 kernel: {routes[path]}")
    for path in ("train_dp_tp", "b32", "remat_large"):   # their float32 steps' backwards
        check(routes[path]["bwd_tf32x3"] > 0, f"{path}: its float32 backwards did not take "
              f"the TF32x3 kernel: {routes[path]}")
    # no backward of phases 2-14 on the two-pass pairs: the long backwards
    # only in phase 12, the TF32x3 long one for the float32 ViT-L/14 step's
    # cross rows (264 keys) and the float32 448 px step's 784 and 792, the
    # bf16 long one for the 672 px step's 1764 and 1772
    two_bwd = {path: r["bwd_two_pass"] for path, r in routes.items() if r["bwd_two_pass"]}
    f32_long = {path: r["bwd_tf32x3_long"] for path, r in routes.items() if r["bwd_tf32x3_long"]}
    bf16_long = {path: r["bwd_long"] for path, r in routes.items() if r["bwd_long"]}
    want_f32 = long_counts["l14_f32"] + long_counts["448_f32"]
    check(not two_bwd and f32_long == {"remat_large": want_f32} and bf16_long == {
              "remat_large": long_counts["672"]} and min(long_counts.values()) > 0,
          f"two-pass backwards on the main path: {two_bwd}; TF32x3 long: {f32_long}, long: "
          f"{bf16_long} (expected phase 12's alone, by step {long_counts})")
    # no forward of phases 2-14 on the two-pass kernels: every float32 one on
    # the TF32x3 kernel, the long kernel only for phase 2's bf16 rows past
    # CLUSTER_LIMIT (the 448x672 and 224x2048 whole requests) and phase 12's
    # 672 px step
    two_pass = {path: r["two_pass"] for path, r in routes.items() if r["two_pass"]}
    long = {path: r["long"] for path, r in routes.items() if r["long"]}
    check(not two_pass and long == {"eval": eval_long, "remat_large": long_counts["672_fwd"]},
          f"two-pass forwards on the main path: {two_pass}; long forwards: {long} (expected "
          f"{eval_long} in eval, the 448x672 and 224x2048 whole requests' long rows, and "
          f"{long_counts['672_fwd']} in phase 12, the 672 px step's)")
    for route in ROUTE_FUNCTIONS:
        check(route.endswith("two_pass") or sum(r[route] for r in routes.values()) > 0,
              f"the {ROUTE_FUNCTIONS[route]} kernel was never launched on the main path")
    rows = phase_device_time(seg, requests, timings, lambda: step(state, batch), b512_step,
                             b32_step, px448_step)

    kernels = []
    for name, src, tpu, key, counter in (
            ("attention_fwd_one_pass", ATTN_SRC, ATTN_TPU, "attention_fwd_train", "one_pass"),
            ("attention_fwd", ATTN_SRC, ATTN_TPU, "attention_fwd_cluster", "cluster"),
            ("attention_fwd_tf32x3", ATTN_TF32_SRC, ATTN_TPU, "attention_fwd_tf32x3", "tf32x3"),
            ("attention_fwd_long", ATTN_LONG_SRC, ATTN_TPU, "attention_fwd_long", "long"),
            ("attention_bwd_one_pass", ATTN_BWD_SRC, ATTN_BWD_TPU, "attention_bwd_one_pass",
             "bwd_one_pass"),
            ("attention_bwd", ATTN_BWD_SRC, ATTN_BWD_TPU, "attention_bwd_cluster", "bwd_cluster"),
            ("attention_bwd_tf32x3", ATTN_BWD_TF32_SRC, ATTN_BWD_TPU, "attention_bwd_tf32x3",
             "bwd_tf32x3"),
            ("attention_bwd_long", ATTN_BWD_LONG_SRC, ATTN_BWD_TPU, "attention_bwd_long",
             "bwd_long"),
            ("attention_bwd_tf32x3_long", ATTN_BWD_LONG_SRC, ATTN_BWD_TPU,
             "attention_bwd_tf32x3_long", "bwd_tf32x3_long"),
            ("group_assign", GROUP_SRC, GROUP_TPU, "grouping", "group_assign"),
            ("group_assign_st", GROUP_SRC, GROUP_ST_TPU, "grouping_st", "group_assign_st")):
        t = timings[summary[key]["timing"]]
        row = dict(rows[summary[key]["timing"]])
        err = summary[key]["max_abs_err"]
        if counter in ROUTE_FUNCTIONS:
            by_path = {path: r[counter] for path, r in routes.items()}
            direction = "attention_bwd" if counter.startswith("bwd_") else "attention_fwd"
            one = counter.endswith("one_pass")
            step_launches = per_step[direction] if one else 0
            request_launches = (per_request[direction] if one else
                                cluster_per_request if counter == "cluster" else
                                eval_long // (2 * (1 + WARM_REQUESTS)) if counter == "long"
                                else 0)
        else:
            by_path = {"eval": eval_counts[counter], "train": train_counts[counter],
                       "train_cli": cli_counts[counter],
                       "train_cli_device_aug": cli_c_counts[counter],
                       "demo": demo_counts[counter],
                       "eval_sharded": sharded_counts[counter] + dp_eval_counts[counter],
                       "train_dp": dp_counts[counter], "train_tp": tp_counts[counter],
                       "studies": studies_counts[counter],
                       **{path: c[counter] for path, c in remat_counts.items()},
                       "train_cli_runM": runm_counts[counter],
                       **{path: c[counter] for path, c in b32_counts.items()},
                       "drift": drift_counts["drift"][counter]}
            step_launches, request_launches = per_step[counter], per_request[counter]
        entry = dict(name=name, route="cuda", source=src, replaces=tpu,
                     launches=sum(by_path.values()), launches_by_path=by_path,
                     launches_per_train_step=step_launches,
                     launches_per_eval_request=request_launches,
                     max_abs_err=err, shape=t["name"],
                     ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                     bound_by=row["bound_by"], library_ms=row["library_ms"],
                     library_call=None, hmma=hmma.get(name))
        if name.startswith("attention_fwd"):
            entry["library_call"] = ("scaled_dot_product_attention forward, no P "
                                     f"({row['library_backend']})")
            entry["host_us"] = (summary["f32_host_us"][counter] if counter == "tf32x3"
                                else summary["long_host_us"][counter] if counter == "long"
                                else summary["host_us"][counter])
        if name == "attention_fwd_tf32x3":       # float32, TF32 off for the library call
            entry["library_call"] = ("scaled_dot_product_attention forward at float32, TF32 "
                                     f"off, no P ({row['library_backend']})")
            entry.update(p_max_abs_err=summary[key]["p_err"],
                         two_pass_max_abs_err=summary[key]["two_pass_err"],
                         two_pass_host_us=summary["f32_host_us"]["two_pass"])
        if name.startswith("attention_bwd"):
            entry["host_us"] = (summary["f32_bwd_host_us"]["tf32x3"] if counter == "bwd_tf32x3"
                                else summary["long_bwd_host_us"]["long"] if counter == "bwd_long"
                                else summary["f32_long_bwd_host_us"]["tf32x3_long"]
                                if counter == "bwd_tf32x3_long"
                                else summary["bwd_host_us"][counter[len("bwd_"):]])
        if name.endswith(("one_pass", "tf32x3", "long")) or name in ("attention_fwd",
                                                                      "attention_bwd"):
            entry["two_pass_ms"] = row["two_pass_ms"]
        if name == "attention_fwd_long":         # PR 3's two-pass kernel in turns beside it
            entry.update(p_max_abs_err=summary[key]["p_err"],
                         two_pass_host_us=summary["long_host_us"]["two_pass"])
        if name == "group_assign_st":
            mae = summary["grouping_st_mae"]
            mae_row = rows[mae["timing"]]
            entry.update(mae_shape=timings[mae["timing"]]["name"], mae_max_abs_err=mae["max_abs_err"],
                         mae_ms=mae_row["ms"], mae_plain_ms=mae_row["plain_ms"],
                         mae_bound_ms=mae_row["bound_ms"], mae_bound_by=mae_row["bound_by"])
        elif name.startswith("attention_bwd"):
            entry["library_call"] = ("scaled_dot_product_attention forward + backward "
                                     f"under autograd ({row['library_backend']}); "
                                     "compare with pair_ms")
            entry["pair_ms"] = row["pair_ms"]
            if name == "attention_bwd_long":       # the mma.sync pair in turns beside it
                entry.update(two_pass_max_abs_err=summary[key]["two_pass_err"],
                             two_pass_host_us=summary["long_bwd_host_us"]["two_pass"])
            if name in ("attention_bwd_tf32x3", "attention_bwd_tf32x3_long"):
                # float32: the SIMT pair in turns beside it
                entry["library_call"] = ("scaled_dot_product_attention forward + backward at "
                                         f"float32, TF32 off, under autograd "
                                         f"({row['library_backend']}); compare with pair_ms")
                host = ("f32_bwd_host_us" if name == "attention_bwd_tf32x3"
                        else "f32_long_bwd_host_us")
                entry.update(rel_err=summary[key]["rel_err"],
                             two_pass_max_abs_err=summary[key]["two_pass_err"],
                             two_pass_host_us=summary[host]["two_pass"])
        if not name.startswith(("attention_fwd", "attention_bwd")) or name.endswith("one_pass"):
            # the cluster and two-pass kernels take no ViT-B/32 row
            b32 = summary[{"attention_fwd_train": "b32_attention_fwd",
                           "attention_bwd_one_pass": "b32_attention_bwd",
                           "grouping": "b32_grouping", "grouping_st": "b32_grouping_st"}[key]]
            b32_row = rows[b32["timing"]]
            entry.update(b32_shape=timings[b32["timing"]]["name"],
                         b32_max_abs_err=b32["max_abs_err"], b32_ms=b32_row["ms"],
                         b32_plain_ms=b32_row["plain_ms"], b32_library_ms=b32_row["library_ms"],
                         b32_bound_ms=b32_row["bound_ms"], b32_bound_by=b32_row["bound_by"])
        if name == "attention_bwd_one_pass":
            entry["b32_pair_ms"] = b32_row["pair_ms"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
