"""The zero-shot eval cells: `segclip_tpu_torch.evalseg.inference.
evaluate_dataset_sharded(segmenter, dataset, images_per_device)` over a
pool of seeded samples, pass after pass, for the window; the segmenter is
the eval CLI's (`cli/eval_zeroshot.build_segmenter`).

The pool: `pool` images whose original sizes, and their order, are the same
for every seed (long side `long_side`, short sides spread evenly over
`short_side`, `landscape` of them wider than tall); smooth seeded colours, keep-ratio resized to a short side of 224 and
normalised with CLIP's pixel mean and std by the harness's own code;
int32 labels at the original size from a coarse seeded class map, 255 on
the class borders.

The window ends at the first group boundary past `--seconds`: the pool's
`load` raises there, after the last group's predictions reached the mIoU
meter. A seeded sample of the pool, with the largest image in it, has its
class logits at the original size (stitched and resized, before the
arg-max) and its labels kept as the program made them, the first time each
comes through the window; the reference decodes them again after the
program is freed."""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.lib import judge, trace, work
from portbench.lib.program import build_model
from portbench.reference import evalseg as ref_eval
from portbench.reference.model import Precision, Sizes, make_params

INPUT_STREAM = 1 << 40


@dataclass
class Sample:
    image: np.ndarray                # normalised float32 (H, W, 3), short side 224
    label: np.ndarray                # int32 (H0, W0)
    orig_shape: Tuple[int, int]


class WindowEnd(Exception):
    """Raised by the pool at the first group boundary past the deadline."""


class Pool:
    """The dataset the evaluator reads: `spec`, `len`, `load(i)`."""

    def __init__(self, spec, samples: List[Sample], per_call: int):
        self.spec, self.samples, self.per_call = spec, samples, per_call
        self.deadline = math.inf
        self.hold = lambda: False           # True while the window must go on

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, i: int) -> Sample:
        if (i % self.per_call == 0 and time.perf_counter() >= self.deadline
                and not self.hold()):
            raise WindowEnd
        return self.samples[i]


def original_sizes(traffic: dict) -> List[Tuple[int, int]]:
    """The pool's (H0, W0), the same for every seed."""
    n, long_side = traffic["pool"], traffic["long_side"]
    lo, hi = traffic["short_side"]
    shorts = np.linspace(lo, hi, n).round().astype(int)
    portrait = set(np.linspace(0, n - 1, n - traffic["landscape"]).round().astype(int).tolist())
    return [(long_side, int(short)) if i in portrait else (int(short), long_side)
            for i, short in enumerate(shorts)]


def resized(h0: int, w0: int, short: int = 224) -> Tuple[int, int]:
    scale = short / min(h0, w0)
    return int(h0 * scale + 0.5), int(w0 * scale + 0.5)


def make_pool(traffic: dict, seed: int, device) -> List[Sample]:
    gen = torch.Generator(device=device).manual_seed(seed + INPUT_STREAM)
    mean = torch.tensor(traffic["pixel_mean"], device=device)
    std = torch.tensor(traffic["pixel_std"], device=device)
    classes, (r_lo, r_hi) = len(traffic["classes"]), traffic["label_regions"]
    samples = []
    for h0, w0 in original_sizes(traffic):
        colours = torch.rand((1, 3, 6, 8), generator=gen, device=device) * 255
        img = F.interpolate(colours, size=(h0, w0), mode="bicubic", align_corners=False)
        img = (img + torch.randn((1, 3, h0, w0), generator=gen, device=device) * 12).clamp(0, 255)
        img = img.round()
        h, w = resized(h0, w0)
        img = F.interpolate(img, size=(h, w), mode="bilinear", align_corners=False)[0]
        image = ((img.permute(1, 2, 0) - mean) / std).float()
        r = int(torch.randint(r_lo, r_hi + 1, (1,), generator=gen, device=device))
        coarse = torch.randint(0, classes, (1, 1, r, r), generator=gen, device=device).float()
        label = F.interpolate(coarse, size=(h0, w0), mode="nearest")[0, 0].long()
        edge = torch.zeros_like(label, dtype=torch.bool)
        edge[:, 1:] |= label[:, 1:] != label[:, :-1]
        edge[1:, :] |= label[1:, :] != label[:-1, :]
        edge = F.max_pool2d(edge[None, None].float(), 5, 1, 2)[0, 0] > 0
        label = torch.where(edge, 255, label).to(torch.int32)
        samples.append(Sample(image.cpu().numpy(), label.cpu().numpy(), (h0, w0)))
    return samples


class ZeroShotCell:
    kind = "zeroshot_eval"

    def __init__(self, cell, seed: int, device: torch.device, fault: Optional[str] = None):
        self.cell, self.seed, self.device, self.fault = cell, seed, device, fault
        self.sizes = Sizes.of(cell.config)
        self.traffic = cell.traffic
        self.kept: Dict[int, tuple] = {}
        self.recording = False
        self.calls = 0
        self.images = 0
        self.call_starts: List[float] = []
        self.stretches: Optional[trace.Stretches] = None
        self.keep_resized = False
        self.resized: Optional[torch.Tensor] = None

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from segclip_tpu_torch.cli.eval_zeroshot import build_segmenter
        from segclip_tpu_torch.evalseg.datasets import DATASET_SPECS
        t = self.traffic
        if t["matmul_precision"] == "highest":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        params = make_params(self.sizes, self.seed, self.device)
        model, mcfg = build_model(self.cell.config, {"compute_dtype": t["compute_dtype"]},
                                  params, self.device)
        del params
        model.eval()
        spec = DATASET_SPECS[t["dataset"]]
        self.segmenter = build_segmenter(model, mcfg, spec, template_set=t["template_set"])
        self.model = model
        self.samples = make_pool(t, self.seed, self.device)
        rng = np.random.default_rng(self.seed)
        largest = max(range(len(self.samples)),
                      key=lambda i: math.prod(self.samples[i].orig_shape))
        others = [i for i in range(len(self.samples)) if i != largest]
        self.checked = {largest, *rng.choice(others, t["checked_images"] - 1, replace=False).tolist()}
        self._hook()
        per_call = t["images_per_device"]
        self.pool = Pool(spec, self.samples, per_call)
        warm = Pool(spec, self.samples[:per_call * t["warm_calls"]], per_call)
        self._evaluate(warm)
        self._sync()

    def _evaluate(self, pool: Pool):
        from segclip_tpu_torch.evalseg.inference import evaluate_dataset_sharded
        return evaluate_dataset_sharded(self.segmenter, pool,
                                        images_per_device=self.traffic["images_per_device"])

    def _hook(self) -> None:
        """Keep the checked samples' logits and labels; time each group;
        take the profiled stretches at group boundaries; plant a test's
        fault."""
        from segclip_tpu_torch.evalseg import inference
        seg = self.segmenter
        labels, predict, stitch = seg._labels, seg.predict_batch, seg._stitch
        self.resize = resize = inference._resize_chw

        def kept_resize(logits, out_h, out_w):
            out = resize(logits, out_h, out_w)
            if self.keep_resized:
                self.resized = out.detach().cpu()
            return out

        def kept_labels(logits, orig_shape):
            idx = self.calls % len(self.samples)
            keep = self.recording and idx in self.checked and idx not in self.kept
            self.calls += self.recording
            self.keep_resized, self.resized = keep, None
            out = labels(logits, orig_shape)
            if keep:
                full = self.resized if self.resized is not None else logits.detach().cpu()
                self.kept[idx] = (full, np.array(out))
            self.keep_resized, self.resized = False, None
            return out

        def timed_predict(images, orig_shapes):
            if self.recording:
                if self.stretches is not None:
                    self.stretches.before(len(self.call_starts))
                self.call_starts.append(time.perf_counter())
            out = predict(images, orig_shapes)
            if self.recording:
                self.images += len(out)
            return out

        def faulty_stitch(logits, wins, h0, w0):
            out = stitch(logits, wins, h0, w0)
            if self.fault == "answer_altered":
                out = out[[1, 0, *range(2, out.shape[0])]]
            elif self.fault == "half_batch" and self.recording and self.calls % 2:
                out = torch.zeros_like(out)
            return out

        inference._resize_chw = kept_resize
        seg._labels, seg.predict_batch = kept_labels, timed_predict
        if self.fault is not None:
            if self.fault not in ("answer_altered", "half_batch"):
                raise ValueError(f"no fault {self.fault!r} in an eval cell")
            seg._stitch = faulty_stitch

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ window
    def window(self, seconds: float, traced: bool) -> dict:
        t = self.traffic
        if traced:
            self.stretches = trace.Stretches(t["profile_after_calls"], t["profiled_calls"],
                                             self.device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.recording = True
        t0 = time.perf_counter()
        self.pool.deadline = t0 + seconds
        self.pool.hold = lambda: traced and not self.stretches.done
        while True:
            try:
                self._evaluate(self.pool)
            except WindowEnd:
                break
        end = time.perf_counter()
        self.recording = False
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        elapsed = end - t0
        starts = self.call_starts + [end]
        # a group's time runs to the next group's start, where a stretch
        # may have started or stopped: a group next to one is left out
        profiled = self.stretches.profiled if traced else (lambda i: False)
        calls = [b - a for i, (a, b) in enumerate(zip(starts, starts[1:]))
                 if not profiled(i) and not profiled(i + 1)]
        per = t["images_per_device"]
        crops = per * t["crops_per_image"]
        dtype = t["compute_dtype"]
        return {"attempted": self.images, "failed": 0,
                "end_to_end": {"eval_img_s": self.images / elapsed},
                "window_peak_bytes": peak,
                "ctx": {"kind": self.kind, "call_s": calls,
                        "summary": self.stretches and self.stretches.summary,
                        "host_summary": self.stretches and self.stretches.host,
                        "units_profiled": t["profiled_calls"] * per if traced else 0,
                        "images_per_call": per,
                        "crop_flops": work.vision_flops(self.sizes, 1),
                        "crops_per_image": t["crops_per_image"],
                        "peak_flops": work.PEAK_FLOPS[dtype],
                        "port_least_s": work.least_seconds(
                            work.crop_calls(self.sizes, crops, dtype)) / per}}

    # ------------------------------------------------------------ check
    def release(self) -> None:
        from segclip_tpu_torch.evalseg import inference
        inference._resize_chw = self.resize
        del self.segmenter, self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_logits(self, precision: str) -> Dict[int, tuple]:
        """The reference's logits and labels at the original size of each
        kept sample."""
        t, s = self.traffic, self.sizes
        prec = Precision(precision)
        P = make_params(s, self.seed, self.device)
        with torch.no_grad():
            bank = ref_eval.text_bank(P, s, t["classes"][1:], t["templates"], prec, self.device)
            out = {}
            for idx in sorted(self.kept):
                sample = self.samples[idx]
                image = torch.from_numpy(sample.image).to(self.device)
                logits = ref_eval.slide_logits(P, s, image, bank, True, t["bg_thresh"],
                                               t["crop"], t["stride"], prec)
                full = ref_eval.resize_logits(logits, *sample.orig_shape)
                out[idx] = (full.cpu(), full.argmax(dim=0).to(torch.int32).cpu())
        return out

    def numbers(self) -> Dict[str, float]:
        ref = self.reference_logits("fp32")
        self.compared = [(self.kept[i][0], ref[i][0], torch.from_numpy(self.kept[i][1]),
                          ref[i][1]) for i in sorted(self.kept)]
        return judge.eval_numbers(self.compared)

    def control_numbers(self, precision: str) -> Dict[str, float]:
        ref, ctrl = self.reference_logits("fp32"), self.reference_logits(precision)
        self.compared = [(ctrl[i][0], ref[i][0], ctrl[i][1], ref[i][1]) for i in sorted(self.kept)]
        return judge.eval_numbers(self.compared)
