"""Drive the PyTorch port's zero-shot segmentation path and its training
step on one CUDA card (an H100) and check them.

    python3 chip_smoke.py

Builds the port's CUDA kernels from segclip_tpu_torch/csrc, then:

  1. kernels vs plain: each kernel against its plain PyTorch version on the
     card, at every shape of both paths, in float32 (TF32 off) and bfloat16,
     with the tolerance stated beside each, and the time per call by CUDA
     events: the attention forward (eval shapes, and training shapes with P
     saved), the attention backward, the eval grouping and the Gumbel
     (training) grouping at each of their shapes, each grouping call run
     twice and required to give the same bits; and the repaired fault: on
     CUDA, the outputs of
     `attention` and `group_assign` require grad when their inputs do;
  2. the eval slice: ViT-B/16 at the default ModelConfig (bfloat16) from a
     seeded random init; a 20-class text bank; four requests through
     ZeroShotSegmenter (224×224 whole, 224×448 slide, a 300×500 image in
     slide mode answered at its original size, one group map); the kernels'
     launch counters must show every attention and grouping call of the
     path went through the kernels;
  3. the eval path against its plain self: one request at float32 on the
     card and on the CPU (where the wrappers take the plain versions);
  4. the training slice: ViT-B/16 at the default ModelConfig (bfloat16,
     vision MAE and seglabel on, text MAE off) from `init_segclip(seed=0)`,
     B = 96 synthetic pairs from numpy seed 0, 1 + 5 steps of
     `make_train_step`: finite losses, frozen parameters bit-identical,
     trainable ones moved, per-step launch counters equal to the path's
     count (attention forward and backward, Gumbel grouping, and the MAE
     decoder's plain-route attention), warm step time and peak memory;
  5. the training step against its plain self: one float32 step at full
     width with B = 2 and injected noise, on the card and on the CPU;
  6. pretraining through the CLI from SGR records: `prepare_data shapes`
     (96 scenes, two captions each, native Felzenszwalb superpixels, a
     4-image VOC-layout eval split), then run A, `cli.train --preset
     shapes-learnability --epochs 2 --num-workers 4` at ViT-B/16 width
     (B = 96, 2 steps per epoch, per-epoch eval on the card, keep_best):
     finite losses, checkpoints, the launch counters of every step and
     every eval request; a resume from run A's first checkpoint must train
     epoch 1 only and reproduce run A's last loss and model.pt; the loop's
     time per step beside phase 4's and the loader's rate alone;
then device time from torch.profiler: each kernel, its plain version and,
for attention, one PyTorch call computing the same function
(`scaled_dot_product_attention`, its backend read from the profiler's
kernel names), at the phase-1 shapes, each beside its bound
(segclip_tpu_torch/ops/kernels/bounds.py); a profile of three warm requests
and of one training step. The build prints each kernel's registers and
spills (ptxas) and, where `cuobjdump` exists, the count of tensor-core
instructions (HMMA) in each kernel; the bf16 attention kernels and the
bf16 grouping kernel must have some. The profiles list the port's own
kernels (those in the `segclip_kernels` namespace) apart from PyTorch's.

Exits non-zero when there is no CUDA card or any check fails. Prints the
card's name and power limit, one JSON line of kernel results ("ms",
"plain_ms", "library_ms", "bound_ms" at each kernel's main shape, and the
Gumbel grouping's at the MAE shape as "mae_*"; launches per training step
and per eval request, and by path: "eval" (phase 2), "train" (phase 4) and
"train_cli" (phase 6's run A)), and as its last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
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
GROUP_SRC = "segclip_tpu_torch/csrc/group_assign.cu"
ATTN_TPU = "segclip_tpu/ops/pallas/attention.py:60"
ATTN_BWD_TPU = "segclip_tpu/ops/pallas/attention.py:96"
GROUP_TPU = "segclip_tpu/ops/pallas/grouping.py:45"
GROUP_ST_TPU = "segclip_tpu/ops/pallas/grouping.py:45 (training=True, entry :158)"

# Attention shapes of the path: (name, B, Lq, Lk, heads, bias, kind).
ATTN_CASES = (
    ("vision 2x196 (slide, 2 windows)", 2, 196, 196, 12, None, "self"),
    ("vision 1x294 (whole 224x336)", 1, 294, 294, 12, None, "self"),
    ("cross 2x8x204", 2, 8, 204, 12, None, "cross"),
    ("group stage 2x8x8", 2, 8, 8, 12, None, "self"),
    ("text 20x77 causal", 20, 77, 77, 8, "causal", "self"),
    ("text 4x77 padding (off the path)", 4, 77, 77, 8, "padding", "self"),
)
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
# Grouping shapes of the path: (name, N, G, L, D).
GROUP_CASES = (
    ("eval 2x8x196x768 (slide)", 2, 8, 196, 768),
    ("eval 1x8x196x768 (whole 224x224)", 1, 8, 196, 768),
    ("eval 1x8x294x768 (whole 224x336)", 1, 8, 294, 768),
)
GROUP_ST_CASES = (
    ("train 96x8x196x768", 96, 8, 196, 768),
    ("train MAE 96x8x48x768", 96, 8, 48, 768),
)
TRAIN_BATCH = 96            # the JAX bench's per-chip batch
TRAIN_STEPS = 5             # timed, after one cold step
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
PROFILE_TRIES = 3           # profiler runs before a time falls back to CUDA events
# Phase 6: the shapes corpus (96 scenes, two captions each: 192 samples, two
# B = 96 steps per epoch) and its eval split; the loader timed alone over
# LOADER_EPOCHS warm epochs after a cold one.
CORPUS_TRAIN_N, CORPUS_EVAL_N = 96, 4
LOADER_WORKERS, LOADER_EPOCHS = 4, 3
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
    if bias == "causal":
        from segclip_tpu_torch.ops.attention import causal_mask
        bias2d = causal_mask(lq, device=dev)
    elif bias == "padding":
        lens = torch.randint(3, lk + 1, (b,), generator=gen, device=dev)
        mask = (torch.arange(lk, device=dev)[None] < lens[:, None]).float()
        biasb = (1.0 - mask) * -1e6
    return q, k, v, bias2d, biasb


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
            out = attention(q, k, v, b2, bb)
            ref = attention_plain(q, k, v, b2, bb)
            torch.cuda.synchronize()
            check(torch.isfinite(out).all().item(), f"attention {case[0]}: non-finite")
            err = (out.float() - ref.float()).abs().max().item()
            kernel = functools.partial(attention, q, k, v, b2, bb)
            plain = functools.partial(attention_plain, q, k, v, b2, bb)
            call, plain_call = call_ms(kernel), call_ms(plain)
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
            print(f"  attention {case[0]:34s} {str(dtype)[6:]:8s} err {err:.3e} "
                  f"(tol {tol:g}){ulp_note}  {call:.4f} / {plain_call:.4f} ms")
            check(err <= tol, f"attention {case[0]} {dtype}: err {err} > {tol}")
            timings.append(dict(name=f"attention {case[0]} {str(dtype)[6:]}", kernel=kernel,
                                plain=plain, work=(*work, dtype),
                                library=sdpa_library(q, k, v, b2, bb)))
            if case is ATTN_CASES[0] and dtype == torch.bfloat16:
                summary["attention"] = dict(max_abs_err=err, timing=len(timings) - 1)

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
            if name == GROUP_CASES[0][0] and dtype == torch.bfloat16:
                summary["grouping"] = dict(max_abs_err=out_err, timing=len(timings) - 1)
    training_kernels(dev, gen, summary, timings)
    repaired_fault(dev)
    return summary, timings


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

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        for case in TRAIN_ATTN_CASES:
            q, k, v, b2, bb = attention_inputs(case, dtype, dev, gen)
            out, p = attention_fwd(q, k, v, b2, bb, save_p=True)
            ref, p_ref = attention_fwd_plain(q, k, v, b2, bb)
            do = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
            grads = attention_bwd(p, do, q, k, v)
            grads_ref = attention_bwd_plain(p, do, q, k, v)
            torch.cuda.synchronize()
            check(all(torch.isfinite(g).all().item() for g in grads),
                  f"attention backward {case[0]}: non-finite")
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
            print(f"  attention {case[0]:34s} {dname:8s} fwd err {out_err:.3e}, P err "
                  f"{p_err:.3e}, bwd rel err dQ/dK/dV {' '.join(f'{r:.2e}' for r in rel)}"
                  f"{note}  fwd {call_ms(fwd):.4f} / {call_ms(fwd_plain):.4f} ms, bwd "
                  f"{call_ms(bwd):.4f} / {call_ms(bwd_plain):.4f} ms")
            _, b, lq, lk, h, bias, _ = case
            timings.append(dict(
                name=f"attention fwd+P {case[0]} {dname}", kernel=fwd, plain=fwd_plain,
                work=(*bounds.attention_fwd_work(b, lq, lk, h, dtype, save_p=True,
                                                 bias2d=b2 is not None,
                                                 biasb=bb is not None), dtype),
                library=sdpa_library(q, k, v, b2, bb)))
            if case is TRAIN_ATTN_CASES[0] and dtype == torch.bfloat16:
                summary["attention_fwd_train"] = dict(max_abs_err=out_err,
                                                      timing=len(timings) - 1)
            timings.append(dict(
                name=f"attention bwd {case[0]} {dname}", kernel=bwd, plain=bwd_plain,
                work=(*bounds.attention_bwd_work(b, lq, lk, h, dtype), dtype),
                library=sdpa_library(q, k, v, b2, bb, do), pair=len(timings) - 1))
            if case is TRAIN_ATTN_CASES[0] and dtype == torch.bfloat16:
                summary["attention_bwd"] = dict(
                    max_abs_err=max((g.float() - r.float()).abs().max().item()
                                    for g, r in zip(grads, grads_ref)),
                    timing=len(timings) - 1)

        for name, n, g, l, d in GROUP_ST_CASES:
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
                  f"bit-identical: {same}  {call_ms(kernel):.4f} / {call_ms(plain):.4f} ms")
            check(same, f"gumbel grouping {name} {dtype}: a second call gave other bits")
            check(n_bad == 0, f"gumbel grouping {name}: hard differs on {n_bad} clear patches")
            check(soft_err <= SOFT_TOL, f"gumbel grouping {name}: soft err {soft_err}")
            check(y_err <= YSOFT_TOL, f"gumbel grouping {name}: y_soft err {y_err}")
            check(out_ok, f"gumbel grouping {name} {dtype}: out err {out_err}{out_note}")
            check(int(hard.sum()) == n * l, f"gumbel grouping {name}: hard is not one-hot")
            timings.append(dict(name=f"gumbel grouping {name} {dname}", kernel=kernel,
                                plain=plain, library=None,
                                work=(*bounds.group_assign_work(n, g, l, d, dtype, True),
                                      dtype)))
            if dtype == torch.bfloat16:
                key = "grouping_st" if name == GROUP_ST_CASES[0][0] else "grouping_st_mae"
                summary[key] = dict(max_abs_err=out_err, timing=len(timings) - 1)


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
        ("224x224 group_map", lambda: seg.group_map(img_224), (224, 224), cfg.group_num),
    )
    for name, fn, shape, upper in requests:
        before = read_counters()
        pred, cold_ms = timed(fn)
        per_request = {k: n - before[k] for k, n in read_counters().items()}
        da, dg = per_request["attention_fwd"], per_request["group_assign"]
        check(pred.shape == shape and pred.dtype == np.int32,
              f"{name}: {pred.shape} {pred.dtype}")
        check(pred.min() >= 0 and pred.max() < upper, f"{name}: labels out of range")
        check(da == 14 and dg == 1, f"{name}: {da} attention / {dg} grouping "
                                    f"launches, expected 14 / 1")
        print(f"  {name}: cold {cold_ms:.1f} ms, labels {np.unique(pred).size} "
              f"distinct, launches attention {da} grouping {dg}")
    counts = read_counters()
    check(counts == {"attention_fwd": 12 + 4 * 14, "attention_bwd": 0, "group_assign": 4,
                     "group_assign_st": 0, "plain_route": 0},
          f"path launch counts {counts}")

    for name, fn, _, _ in requests:                   # warm latency, uncounted
        warm = sorted(timed(fn)[1] for _ in range(7))
        print(f"  {name}: warm median {warm[3]:.2f} ms (min {warm[0]:.2f}, "
              f"max {warm[-1]:.2f}, 7 runs)")
    for logits in (seg.whole(img_224), seg.slide(img_300x500)):
        check(np.isfinite(logits).all(), "non-finite logits")
    print(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB")
    return model, seg, requests, counts, per_request


def train_path_counts(cfg) -> dict:
    """Launches of one training step, from the configuration: the text
    tower, the grouping path's vision tower (layers0, cross blocks, group
    stage) and, with vision MAE, the masked vision forward (layers0, cross
    blocks, layers_mae2) run the attention kernels forward and backward;
    each SemanticLearner runs the Gumbel grouping once; the MAE decoders'
    blocks take the plain route."""
    vision = cfg.vision_layers + cfg.cross_layer          # layers0 + cross + second stage
    attn = cfg.transformer_layers + vision
    plain = 0
    if cfg.use_vision_mae_recon:
        attn += vision
        plain += cfg.mae_decoder_depth
    if cfg.use_text_mae_recon:
        attn += cfg.transformer_layers
        plain += cfg.mae_decoder_depth
    st = 1 + int(cfg.use_vision_mae_recon)
    return {"attention_fwd": attn, "attention_bwd": attn, "group_assign": 0,
            "group_assign_st": st, "plain_route": plain}


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
        metrics, ms = timed(lambda: step(state, batch))
        counts = read_counters()
        check(counts == expected, f"step {i}: launches {counts}, expected {expected}")
        for key, n in counts.items():
            totals[key] = totals.get(key, 0) + n
        values = {k: float(v) for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in values.values()), f"step {i}: {values}")
        check(values["skipped_nan"] == 0.0, f"step {i} was skipped")
        times.append(ms)
        print(f"  step {i} ({'cold' if i == 0 else 'warm'}): {ms:.1f} ms; " + ", ".join(
            f"{k} {v:.5f}" for k, v in values.items()))
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
    return model, step, state, batch, totals, statistics.median(warm)


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


def phase_train_plain_self(dev, model) -> None:
    """Phase 5: one float32 training step at full width, B = 2, with the
    same injected noise on the card and on the CPU."""
    from segclip_tpu_torch.config import Config, ModelConfig
    from segclip_tpu_torch.models.segclip import SegCLIP
    from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step

    mcfg = ModelConfig(compute_dtype="float32")
    cfg = Config(model=mcfg)
    b, g, l = 2, mcfg.group_num, mcfg.num_patches
    kept = int((l + 1) * (1 - mcfg.mae_vis_mask_ratio)) - 1
    rng = np.random.default_rng(5)
    noise = {"gumbel": rng.gumbel(size=(b, g, l)), "gumbel_mae": rng.gumbel(size=(b, g, kept)),
             "mask_vis": rng.random((b, l + 1))}
    noise = {k: torch.from_numpy(v.astype(np.float32)) for k, v in noise.items()}
    batch = synthetic_batch(b, mcfg, 1, "cpu")
    runs = []
    for device in (dev, torch.device("cpu")):
        m = SegCLIP(mcfg)
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
    (loss_gpu, rec_gpu, grads_gpu), (loss_cpu, rec_cpu, grads_cpu) = runs
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    n_near = n_bad = 0
    for (hard_gpu, _), (hard_cpu, margin) in zip(rec_gpu, rec_cpu):
        near = margin < NEAR_TIE
        differ = (hard_gpu != hard_cpu).any(dim=1)
        n_near += int(near.sum())
        n_bad += int((differ & ~near).sum())
    print(f"phase 5: float32 training step, B=2, card vs CPU: loss {loss_gpu:.7f} / "
          f"{loss_cpu:.7f} (rel {rel:.2e}); hard assignments differ on {n_bad} clear "
          f"patches, {n_near} near-tie patches (margin < {NEAR_TIE:g})")
    check(np.isfinite(loss_gpu) and rel <= TRAIN_LOSS_RTOL, f"loss rel err {rel}")
    check(n_bad == 0, f"hard assignments differ on {n_bad} clear patches")
    check(grads_gpu.keys() == grads_cpu.keys(), "different parameters got gradients")
    if n_near:
        print(f"  near-tie patches present: gradients not compared")
        return
    worst = max(((grads_gpu[n] - grads_cpu[n]).abs().max().item()
                 / (1 + grads_cpu[n].abs().max().item()), n) for n in grads_cpu)
    print(f"  no near-tie patch: gradients compared on {len(grads_cpu)} tensors, worst "
          f"{worst[0]:.2e}·(1 + max|g|) at {worst[1]} (tol {TRAIN_GRAD_TOL:g})")
    check(worst[0] <= TRAIN_GRAD_TOL, f"gradient of {worst[1]} off by {worst[0]}")


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


def loader_rate(data: str, batch: int) -> tuple:
    """(batches per second of BatchLoader.epoch alone over LOADER_EPOCHS
    epochs, seconds of the cold epoch before them that spawns the workers),
    with LOADER_WORKERS spawned workers and the phase-6 corpus and dataset
    settings."""
    from segclip_tpu_torch.config import DataConfig
    from segclip_tpu_torch.data.pipeline import BatchLoader, ShardedEpochSampler, build_dataset

    factory = functools.partial(build_dataset, DataConfig(
        datatype="shapes", data_dir=data, batch_size=batch, transfer="rgb"),
        use_seg=True, normalize=False)
    dataset = factory()
    sampler = ShardedEpochSampler(len(dataset), batch, seed=42)
    loader = BatchLoader(dataset, sampler, seed=42, num_workers=LOADER_WORKERS,
                         dataset_factory=factory)
    try:
        t0 = time.perf_counter()
        check(len(list(loader.epoch(0))) == sampler.steps, "loader: short cold epoch")
        t1 = time.perf_counter()
        n = sum(1 for epoch in range(1, 1 + LOADER_EPOCHS) for _ in loader.epoch(epoch))
        return n / (time.perf_counter() - t1), t1 - t0
    finally:
        loader.close()


def phase_train_cli(smi: str, warm_step_ms: float) -> dict:
    """Phase 6: pretraining through the CLI from SGR records made on the
    machine, at ViT-B/16 width in bf16 (the preset's B = 96), per-epoch eval
    on the card, keep_best, and a resume that must reproduce the last
    epoch. Returns the launch counts of run A."""
    import tempfile
    from segclip_tpu_torch.cli import prepare_data
    from segclip_tpu_torch.cli import train as train_cli
    from segclip_tpu_torch.config import ModelConfig

    cfg = ModelConfig()
    expected_step = train_path_counts(cfg)
    expected_request = {"attention_fwd": cfg.vision_layers + cfg.cross_layer,
                        "attention_bwd": 0, "group_assign": 1, "group_assign_st": 0,
                        "plain_route": 0}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data, run_a, run_b = (os.path.join(tmp, d) for d in ("shapes", "a", "b"))
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
        with open(os.path.join(run_a, "log.txt")) as f:
            step_times = [float(t) for t in re.findall(r"Time/step ([0-9.]+)", f.read())]
        print(f"  prepare_data shapes --train-n {CORPUS_TRAIN_N} --eval-n {CORPUS_EVAL_N}: "
              f"{prep_s:.2f} s; run A (2 epochs, 4 steps, 2 evals, "
              f"{len(result_a['checkpoints'])} epoch checkpoints + best): {run_a_s:.1f} s")
        print(f"  run A losses {' '.join(f'{v:.5f}' for v in losses_a)}; mIoU per epoch "
              f"{' '.join(f'{v:.2f}' for v in mious)}; launches per step {path.steps}")
        check(len(losses_a) == 4 and all(np.isfinite(losses_a)), f"run A losses {losses_a}")
        check(len(mious) == 2 and all(np.isfinite(mious)), f"run A mIoU lines {mious}")
        for name in ("ckpt_epoch_0", "ckpt_epoch_1", "ckpt_best", "best.json"):
            check(os.path.exists(os.path.join(run_a, name)), f"run A wrote no {name}")
        check(len(path.steps) == 4 and all(c == expected_step for c in path.steps),
              f"launches per step {path.steps}, expected {expected_step}")
        check(len(path.requests) == 2 * CORPUS_EVAL_N
              and all(c == expected_request for c in path.requests),
              f"launches per eval request {path.requests}, expected {expected_request}")
        text_banks = {k: counts[k] - sum(c[k] for c in path.steps + path.requests)
                      for k in counts}
        check(text_banks == {**{k: 0 for k in counts},
                             "attention_fwd": 2 * cfg.transformer_layers},
              f"launches outside the steps and requests {text_banks}: expected the two "
              f"text banks' attention only")

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
        torch.cuda.empty_cache()

        (rate_96, cold_96), (rate_24, _) = loader_rate(data, TRAIN_BATCH), loader_rate(data, 24)
    print(f"  the input pipeline against the card ({smi}): the loop's Time/step "
          f"{' '.join(f'{t * 1e3:.1f}' for t in step_times)} ms (steps 1 and 3 open an "
          f"epoch); phase 4's warm synthetic step {warm_step_ms:.2f} ms; the loader alone "
          f"with {LOADER_WORKERS} workers: a cold epoch (spawn, then 2 batches) {cold_96:.2f} "
          f"s, then {rate_96:.2f} batches of {TRAIN_BATCH}/s "
          f"({rate_96 * TRAIN_BATCH:.0f} img/s, 2 batches per epoch), {rate_24:.2f} batches "
          f"of 24/s ({rate_24 * 24:.0f} img/s, 8 per epoch); the step alone "
          f"{1e3 / warm_step_ms:.2f} steps/s ({TRAIN_BATCH * 1e3 / warm_step_ms:.0f} img/s); "
          f"phase 6 took {time.perf_counter() - t_phase:.1f} s")
    return counts


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


def phase_device_time(seg, requests, timings, train_step) -> list:
    """Device time from torch.profiler, last: profiling slows the launches
    that follow it, so nothing is timed by the host clock after this. For
    each timing: the kernel's and the plain version's ms per call, the
    library call's (attention only) with its backend, and the bound."""
    from segclip_tpu_torch.ops.kernels.bounds import bound_ms
    print("device time (torch.profiler; ms per call: kernel / plain / library "
          "[SDPA backend]; bound from bounds.py at 3.35 TB/s, 989 TFLOP/s bf16, "
          "67 TFLOP/s f32; the bwd rows' library is SDPA forward + backward, set "
          "against the kernels' fwd+P + bwd pair)")
    rows = []
    for t in timings:
        row = dict(ms=device_ms(t["kernel"])[0], plain_ms=device_ms(t["plain"])[0],
                   library_ms=None, library_backend=None)
        row["bound_ms"], row["bound_by"] = bound_ms(*t["work"])
        if t["library"] is not None:
            row["library_ms"], top = device_ms(t["library"])
            row["library_backend"] = sdpa_backend(top)
        lib = ("none" if row["library_ms"] is None else
               f"{row['library_ms']:.4f} [{row['library_backend']}]")
        pair = ""
        if "pair" in t:
            row["pair_ms"] = rows[t["pair"]]["ms"] + row["ms"]
            pair = f"; fwd+P + bwd pair {row['pair_ms']:.4f}"
        print(f"  {t['name']:58s} {row['ms']:.4f} / {row['plain_ms']:.4f} / {lib}; "
              f"bound {row['bound_ms']:.4f} ({row['bound_by']}), kernel at "
              f"{row['bound_ms'] / row['ms']:.1%} of it{pair}")
        rows.append(row)
    for name, fn, _, _ in requests[:3]:
        print_profile(name, fn)
    print_profile(f"training step B={TRAIN_BATCH}", train_step)
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
    return f"{name}<{', '.join(args)}>" if args else name


def print_ptxas(log: str) -> None:
    """One line per kernel: registers, shared memory and spills (ptxas -v)."""
    name, notes = None, []
    for line in log.splitlines() + ["Compiling entry function 'end'"]:
        if "Compiling entry function" in line:
            if name:
                print(f"  ptxas: {kernel_name(name):34s} " + "; ".join(notes))
            name, notes = line.split("'")[1], []
        elif name and ("registers" in line or "spill" in line):
            notes.append(line.split(":", 1)[-1].strip())


def tensor_core_counts(library) -> dict:
    """Where cuobjdump exists: the HMMA (tensor-core) instructions in each
    kernel's SASS, printed; the bf16 attention kernels and the bf16
    grouping kernel's 16-byte path must have some. Returns {"attention_fwd":
    n, "attention_bwd": n, "group_assign": n, "group_assign_st": n} (empty
    without cuobjdump)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("  cuobjdump not found: tensor-core instructions not counted")
        return {}
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = kernel_name(found.group(1))
            counts[name] = 0
        elif name and re.search(r"\bHMMA\b|\bHGMMA\b", line):
            counts[name] += 1
    print("  SASS tensor-core instructions (HMMA/HGMMA) per kernel: " + ", ".join(
        f"{k} {v}" for k, v in sorted(counts.items())))
    group = "group_assign_kernel<bf16, true>"
    for kernel in ("attention_fwd_bf16_kernel", "attention_bwd_dq_bf16_kernel",
                   "attention_bwd_dkv_bf16_kernel", group):
        check(counts.get(kernel, 0) > 0, f"{kernel}: no tensor-core instruction in its SASS")
    return {"attention_fwd": counts["attention_fwd_bf16_kernel"],
            "attention_bwd": counts["attention_bwd_dq_bf16_kernel"]
            + counts["attention_bwd_dkv_bf16_kernel"],
            "group_assign": counts[group], "group_assign_st": counts[group]}


def phase_plain_self(dev, model, cfg) -> None:
    """Phase 3: one float32 request on the card and on the CPU."""
    from segclip_tpu_torch.evalseg.inference import ZeroShotSegmenter
    from segclip_tpu_torch.evalseg.text_bank import build_text_bank
    from segclip_tpu_torch.models.segclip import SegCLIP
    from segclip_tpu_torch.ops.kernels.attention import attention
    from segclip_tpu_torch.ops.kernels.grouping import group_assign

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    img = np.random.default_rng(1).standard_normal((224, 224, 3), dtype=np.float32)
    logits = {}
    for device in (dev, torch.device("cpu")):
        m = SegCLIP(cfg32)
        m.load_state_dict(model.state_dict())
        m = m.to(device).eval()
        counts = (attention.launches, group_assign.launches)
        bank = build_text_bank(m, VOC_CLASSES, "simple", cfg32.context_length)
        seg = ZeroShotSegmenter(m, bank, with_bg=True, bg_thresh=VOC_BG_THRESH,
                                patch_size=cfg32.vision_patch_size)
        logits[device.type] = seg.whole(img)
        moved = (attention.launches, group_assign.launches) != counts
        check(moved == (device.type == "cuda"),
              f"{device}: kernel launches {'' if moved else 'not '}counted")
    gpu, cpu = logits["cuda"], logits["cpu"]
    diff = np.abs(gpu - cpu)
    agree = float((diff.max(axis=0) <= E2E_PIXEL_TOL).mean())
    argmax_agree = float((gpu.argmax(0) == cpu.argmax(0)).mean())
    print(f"phase 3: float32 224x224 whole, card vs CPU: max |dlogit| "
          f"{diff.max():.3e}, median {np.median(diff):.3e}; pixels within "
          f"{E2E_PIXEL_TOL:g}: {agree:.5f}; argmax agree {argmax_agree:.5f}")
    check(np.isfinite(gpu).all() and np.isfinite(cpu).all(), "non-finite logits")
    check(agree >= E2E_MIN_AGREE, f"only {agree:.5f} of pixels agree")
    check(argmax_agree >= E2E_MIN_AGREE, f"argmax agrees on {argmax_agree:.5f}")


def main() -> int:
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

    t0 = time.perf_counter()
    build.load()
    print(f"kernel build + load: {time.perf_counter() - t0:.1f} s")
    print_ptxas(build.build_log())
    hmma = tensor_core_counts(build.build())

    summary, timings = phase_kernels(dev)
    cfg = ModelConfig()
    model, seg, requests, eval_counts, per_request = phase_slice(dev, cfg)
    phase_plain_self(dev, model, cfg)
    train_model, step, state, batch, train_counts, warm_step_ms = phase_train(dev)
    per_step = train_path_counts(cfg)
    phase_train_plain_self(dev, train_model)
    cli_counts = phase_train_cli(smi, warm_step_ms)
    rows = phase_device_time(seg, requests, timings, lambda: step(state, batch))

    kernels = []
    for name, src, tpu, key, counter in (
            ("attention_fwd", ATTN_SRC, ATTN_TPU, "attention_fwd_train", "attention_fwd"),
            ("attention_bwd", ATTN_BWD_SRC, ATTN_BWD_TPU, "attention_bwd", "attention_bwd"),
            ("group_assign", GROUP_SRC, GROUP_TPU, "grouping", "group_assign"),
            ("group_assign_st", GROUP_SRC, GROUP_ST_TPU, "grouping_st", "group_assign_st")):
        t = timings[summary[key]["timing"]]
        row = rows[summary[key]["timing"]]
        by_path = {"eval": eval_counts[counter], "train": train_counts[counter],
                   "train_cli": cli_counts[counter]}
        entry = dict(name=name, route="cuda", source=src, replaces=tpu,
                     launches=sum(by_path.values()), launches_by_path=by_path,
                     launches_per_train_step=per_step[counter],
                     launches_per_eval_request=per_request[counter],
                     max_abs_err=summary[key]["max_abs_err"], shape=t["name"],
                     ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                     bound_by=row["bound_by"], library_ms=row["library_ms"],
                     library_call=None, hmma=hmma.get(name))
        if name == "attention_fwd":
            entry["library_call"] = ("scaled_dot_product_attention forward, no P "
                                     f"({row['library_backend']})")
        elif name == "group_assign_st":
            mae = summary["grouping_st_mae"]
            mae_row = rows[mae["timing"]]
            entry.update(mae_shape=timings[mae["timing"]]["name"], mae_max_abs_err=mae["max_abs_err"],
                         mae_ms=mae_row["ms"], mae_plain_ms=mae_row["plain_ms"],
                         mae_bound_ms=mae_row["bound_ms"], mae_bound_by=mae_row["bound_by"])
        elif name == "attention_bwd":
            entry["library_call"] = ("scaled_dot_product_attention forward + backward "
                                     f"under autograd ({row['library_backend']}); "
                                     "compare with pair_ms")
            entry["pair_ms"] = row["pair_ms"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
