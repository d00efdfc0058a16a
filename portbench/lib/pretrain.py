"""The pretraining cells: `segclip_tpu_torch.train.step.make_train_step`'s
step in a closed loop over a ring of batches on the device.

Set-up draws the weights and the ring from the seed, builds the model, the
optimizer and the step once, and takes the traffic's checked steps (the
window's own call on the ring's first batches), reading each step's loss,
the first step's gradient per leaf from the optimizer's first moment, and
each leaf's change after the last checked step; one more step warms the
last batch of the ring. The same object then runs the window. After it,
the program is freed and the plain reference takes the checked steps from
the same weights, batches and draws."""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from portbench.lib import judge, trace, work
from portbench.lib.program import build_model
from portbench.reference import train as ref_train
from portbench.reference.model import Precision, Sizes, make_params

INPUT_STREAM = 1 << 40          # the inputs' generator seed is seed + this
BOS, EOS = 49406, 49407


def make_batches(s: Sizes, traffic: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """The ring: `ring` batches of `batch` rows. Captions of
    caption_tokens[0]..[1] tokens (BOS and EOS included) of ids drawn below
    BOS, zero-padded to max_words; uint8 RGB images; superpixel maps on the
    patch grid as Voronoi cells of superpixels[0]..[1] seeded centres."""
    gen = torch.Generator(device=device).manual_seed(seed + INPUT_STREAM)
    b, words, g = traffic["batch"], s.max_words, s.grid
    lo, hi = traffic["caption_tokens"]
    k_lo, k_hi = traffic["superpixels"]
    ring = []
    for _ in range(traffic["ring"]):
        n = torch.randint(lo, hi + 1, (b, 1), generator=gen, device=device)
        pos = torch.arange(words, device=device)[None]
        ids = torch.randint(1, BOS, (b, words), generator=gen, device=device)
        ids = torch.where(pos == 0, BOS, torch.where(pos == n - 1, EOS, ids))
        ids = torch.where(pos < n, ids, 0)
        image = torch.randint(0, 256, (b, s.image_resolution, s.image_resolution, 3),
                              generator=gen, device=device, dtype=torch.uint8)
        k = torch.randint(k_lo, k_hi + 1, (b, 1, 1), generator=gen, device=device)
        centres = torch.rand((b, k_hi, 2), generator=gen, device=device) * g
        yy, xx = torch.meshgrid(torch.arange(g, device=device), torch.arange(g, device=device),
                                indexing="ij")
        cells = torch.stack([yy, xx], -1).reshape(1, g * g, 1, 2).float() + 0.5
        dist = (cells - centres[:, None]).square().sum(-1)                   # (B, L, K)
        dist = dist.masked_fill(torch.arange(k_hi, device=device)[None, None] >= k, float("inf"))
        ring.append({"input_ids": ids, "attention_mask": (pos < n).to(torch.int32),
                     "image": image, "image_seg": dist.argmin(-1).reshape(b, g, g)})
    return ring


def optim_config(traffic: dict):
    from segclip_tpu_torch.config import OptimConfig
    return OptimConfig(**traffic["optim"])


class PretrainCell:
    kind = "pretrain"

    def __init__(self, cell, seed: int, device: torch.device, fault: Optional[str] = None):
        self.cell, self.seed, self.device, self.fault = cell, seed, device, fault
        self.sizes = Sizes.of(cell.config)
        self.traffic = cell.traffic
        self.step_seed = seed % (1 << 31)       # the step's seed must fit 31 bits
        self.prog: Dict[str, object] = {}

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from segclip_tpu_torch.config import Config, TrainConfig
        from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step
        t = self.traffic
        params = make_params(self.sizes, self.seed, self.device)
        model, mcfg = build_model(self.cell.config, {"compute_dtype": t["compute_dtype"],
                                                     "remat": t["remat"]}, params, self.device)
        cfg = Config(model=mcfg, optim=optim_config(t), train=TrainConfig(seed=self.step_seed))
        optimizer = create_optimizer(model, cfg, t["t_total"])
        self._plant(model, optimizer)
        self.ring = make_batches(self.sizes, t, self.seed, self.device)
        self.step = make_train_step(model, optimizer, cfg)
        self.state = TrainState(step=0, seed=self.step_seed)
        self.model, self.optimizer = model, optimizer
        names = {p: n for n, p in model.named_parameters()}
        losses = []
        for i in range(t["checked_steps"]):
            losses.append(float(self.step(self.state, self.ring[i % len(self.ring)])["loss"]))
            if i == 0:
                b1 = t["optim"]["b1"]
                self.prog["grad_norms"] = {
                    names[p]: float(optimizer.state[p]["exp_avg"].float().norm()) / (1 - b1)
                    for p in names if p.requires_grad and "exp_avg" in optimizer.state[p]}
        self.prog["losses"] = losses
        self.prog["change_norms"] = {n: float((p.detach() - params[n]).norm())
                                     for n, p in model.named_parameters() if p.requires_grad}
        del params
        while self.state.step < t["checked_steps"] + t["warm_steps"]:
            self.step(self.state, self.ring[self.state.step % len(self.ring)])
        self._sync()

    def _plant(self, model, optimizer) -> None:
        """The faults a test plants under the timed path."""
        if self.fault == "state_unchanged":
            optimizer.step = lambda closure=None: None
        elif self.fault == "half_batch":
            forward = model.forward

            def half(input_ids, attention_mask, image, image_seg=None, **kw):
                h = input_ids.shape[0] // 2
                return forward(input_ids[:h], attention_mask[:h], image[:h],
                               None if image_seg is None else image_seg[:h], **kw)
            model.forward = half
        elif self.fault is not None:
            raise ValueError(f"no fault {self.fault!r} in a pretraining cell")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ window
    def window(self, seconds: float, traced: bool) -> dict:
        ring, b = self.ring, self.traffic["batch"]
        stretches = (trace.Stretches(2, self.traffic["profiled_steps"], self.device)
                     if traced else None)
        each, skipped, steps = [], 0, 0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        while True:
            if stretches is not None:
                stretches.before(steps)
            s0 = time.perf_counter()
            metrics = self.step(self.state, ring[self.state.step % len(ring)])
            skipped += int(metrics["skipped_nan"])
            each.append(time.perf_counter() - s0)
            steps += 1
            if (time.perf_counter() - t0 >= seconds
                    and (stretches is None or stretches.done)):
                break
        self._sync()
        elapsed = time.perf_counter() - t0
        durations = [d for i, d in enumerate(each)
                     if stretches is None or not stretches.profiled(i)]
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        s = self.sizes
        return {"attempted": steps, "failed": skipped,
                "end_to_end": {"train_img_s": steps * b / elapsed,
                               "train_peak_gib": peak / 2 ** 30},
                "window_peak_bytes": peak,
                "ctx": {"kind": self.kind, "step_s": durations,
                        "summary": stretches and stretches.summary,
                        "host_summary": stretches and stretches.host,
                        "units_profiled": self.traffic["profiled_steps"] if traced else 0,
                        "batch": b,
                        "model_flops": work.step_model_flops(s, b),
                        "port_least_s": work.least_seconds(
                            work.step_calls(s, b, self.traffic["compute_dtype"]))}}

    # ------------------------------------------------------------ check
    def release(self) -> None:
        """Free the program's model, optimizer and step; keep the inputs."""
        self.ring = self.ring[:self.traffic["checked_steps"]]
        del self.step, self.model, self.optimizer
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str) -> dict:
        t = self.traffic
        return ref_train.run_steps(make_params(self.sizes, self.seed, self.device), self.sizes,
                                   self.ring[:t["checked_steps"]], self.step_seed, t["optim"],
                                   t["t_total"], Precision(precision), t["reference_block"])

    def numbers(self) -> Dict[str, float]:
        self.compared = (self.prog, self.reference("fp32"))
        return judge.train_numbers(*self.compared)

    def control_numbers(self, precision: str) -> Dict[str, float]:
        self.compared = (self.reference(precision), self.reference("fp32"))
        return judge.train_numbers(*self.compared)
