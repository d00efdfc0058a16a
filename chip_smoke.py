"""Drive the PyTorch port's zero-shot segmentation path once on one CUDA card
(an H100) and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from segclip_tpu_torch/csrc, then:

  1. kernels vs plain: each kernel against its plain PyTorch version on the
     card, at every main-path shape, in float32 (TF32 off) and bfloat16,
     with the tolerance stated beside each, and the time per call by CUDA
     events;
  2. the slice: ViT-B/16 at the default ModelConfig (bfloat16) from a seeded
     random init; a 20-class text bank; four requests through
     ZeroShotSegmenter (224×224 whole, 224×448 slide, a 300×500 image in
     slide mode answered at its original size, one group map); the kernels'
     launch counters must show every attention and grouping call of the
     path went through the kernels;
  3. the path against its plain self: one request at float32 on the card and
     on the CPU (where the wrappers take the plain versions);
then device time from torch.profiler: each kernel and its plain version at
the phase-1 shapes (the "ms"/"plain_ms" of the JSON line, at the main
shape: vision 2×196, bfloat16), and a profile of three warm requests.

Exits non-zero when there is no CUDA card or any check fails. Prints the
card's name and power limit, one JSON line of kernel results, and as its
last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import functools
import json
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
GROUP_SRC = "segclip_tpu_torch/csrc/group_assign.cu"
ATTN_TPU = "segclip_tpu/ops/pallas/attention.py:60"
GROUP_TPU = "segclip_tpu/ops/pallas/grouping.py:45"

# Attention shapes of the path: (name, B, Lq, Lk, heads, bias, kind).
ATTN_CASES = (
    ("vision 2x196 (slide, 2 windows)", 2, 196, 196, 12, None, "self"),
    ("vision 1x294 (whole 224x336)", 1, 294, 294, 12, None, "self"),
    ("cross 2x8x204", 2, 8, 204, 12, None, "cross"),
    ("group stage 2x8x8", 2, 8, 8, 12, None, "self"),
    ("text 20x77 causal", 20, 77, 77, 8, "causal", "self"),
    ("text 4x77 padding (off the path)", 4, 77, 77, 8, "padding", "self"),
)
# Grouping shapes of the path: (name, N, G, L, D).
GROUP_CASES = (
    ("eval 2x8x196x768 (slide)", 2, 8, 196, 768),
    ("eval 1x8x294x768 (whole 224x336)", 1, 8, 294, 768),
)
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
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SOFT_TOL = 1e-4
OUT_TOL_F32 = 1e-5
NEAR_TIE = 1e-3
# Phase 3: float32 whole-image logits on the card and on the CPU.
E2E_PIXEL_TOL = 1e-3        # a pixel agrees if every class logit is within this
E2E_MIN_AGREE = 0.999       # share of pixels that must agree, and argmax-agree


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
    what ran on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    check(sum(e.self_device_time_total for e in rows) > 0,
          "the profiler saw no device time")
    return rows


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call: the summed durations of every kernel and
    copy it ran on the card, averaged over `reps` calls."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(reps):
            fn()

    return sum(e.self_device_time_total for e in device_rows(run)) / reps / 1e3


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
            timings.append((f"attention {case[0]} {str(dtype)[6:]}", kernel, plain))
            if case is ATTN_CASES[0] and dtype == torch.bfloat16:
                summary["attention"] = dict(max_abs_err=err, timing=len(timings) - 1)

        for name, n, g, l, d in GROUP_CASES:
            q = torch.randn(n, g, d, generator=gen, device=dev).to(dtype)
            k = torch.randn(n, l, d, generator=gen, device=dev).to(dtype)
            v = torch.randn(n, l, d, generator=gen, device=dev).to(dtype)
            out, hard, soft = group_assign(q, k, v)
            _, hard_ref, soft_ref = group_assign_plain(q, k, v)
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
                  f"(margin < {NEAR_TIE:g})  {call:.4f} / {plain_call:.4f} ms")
            check(n_bad == 0, f"grouping {name}: hard differs on {n_bad} clear patches")
            check(soft_err <= SOFT_TOL, f"grouping {name}: soft err {soft_err}")
            check(out_ok, f"grouping {name} {dtype}: out err {out_err}{out_note}")
            check(int(hard.sum()) == n * l, f"grouping {name}: hard is not one-hot")
            timings.append((f"grouping {name} {str(dtype)[6:]}", kernel, plain))
            if name == GROUP_CASES[0][0] and dtype == torch.bfloat16:
                summary["grouping"] = dict(max_abs_err=out_err, timing=len(timings) - 1)
    return summary, timings


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, (time.perf_counter() - t0) * 1e3


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

    attention.launches = 0
    group_assign.launches = 0
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
        a0, g0 = attention.launches, group_assign.launches
        pred, cold_ms = timed(fn)
        da, dg = attention.launches - a0, group_assign.launches - g0
        check(pred.shape == shape and pred.dtype == np.int32,
              f"{name}: {pred.shape} {pred.dtype}")
        check(pred.min() >= 0 and pred.max() < upper, f"{name}: labels out of range")
        check(da == 14 and dg == 1, f"{name}: {da} attention / {dg} grouping "
                                    f"launches, expected 14 / 1")
        print(f"  {name}: cold {cold_ms:.1f} ms, labels {np.unique(pred).size} "
              f"distinct, launches attention {da} grouping {dg}")
    counts = {"attention": attention.launches, "grouping": group_assign.launches}
    check(counts == {"attention": 12 + 4 * 14, "grouping": 4},
          f"path launch counts {counts}")

    for name, fn, _, _ in requests:                   # warm latency, uncounted
        warm = sorted(timed(fn)[1] for _ in range(7))
        print(f"  {name}: warm median {warm[3]:.2f} ms (min {warm[0]:.2f}, "
              f"max {warm[-1]:.2f}, 7 runs)")
    for logits in (seg.whole(img_224), seg.slide(img_300x500)):
        check(np.isfinite(logits).all(), "non-finite logits")
    print(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB")
    return model, seg, requests, counts


def phase_device_time(seg, requests, timings) -> list:
    """Device time from torch.profiler, last: profiling slows the launches
    that follow it, so nothing is timed by the host clock after this."""
    print("device time (torch.profiler; ms per call, kernel / plain)")
    ms = []
    for name, kernel, plain in timings:
        ms.append((device_ms(kernel), device_ms(plain)))
        print(f"  {name:58s} {ms[-1][0]:.4f} / {ms[-1][1]:.4f}")
    for name, fn, _, _ in requests[:3]:
        box = {}
        rows = device_rows(lambda: box.setdefault("wall", timed(fn)[1]))
        busy = sum(e.self_device_time_total for e in rows) / 1e3
        print(f"  {name}, profiled: wall {box['wall']:.2f} ms, device busy "
              f"{busy:.3f} ms, idle share {1 - busy / box['wall']:.3f}; top:")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"    {e.self_device_time_total / 1e3:7.3f} ms {e.count:4d}x  "
                  f"{e.key[:80]}")
    return ms


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
    from segclip_tpu_torch.models.segclip import ModelConfig
    from segclip_tpu_torch.utils.device import resolve_device

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    dev = resolve_device("cuda")
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build.load()
    print(f"kernel build + load: {time.perf_counter() - t0:.1f} s")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    summary, timings = phase_kernels(dev)
    cfg = ModelConfig()
    model, seg, requests, counts = phase_slice(dev, cfg)
    phase_plain_self(dev, model, cfg)
    ms = phase_device_time(seg, requests, timings)

    kernels = []
    for name, src, tpu, key in (("attention_fwd", ATTN_SRC, ATTN_TPU, "attention"),
                                ("group_assign", GROUP_SRC, GROUP_TPU, "grouping")):
        kernel_ms, plain_ms = ms[summary[key]["timing"]]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=tpu,
                            launches=counts[key],
                            max_abs_err=summary[key]["max_abs_err"],
                            ms=kernel_ms, plain_ms=plain_ms))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
