"""AdaptAdamW: AdamW with the LR schedule inside the step and the weight
decay applied before the update (segclip_tpu/train/optimizer.py, itself the
reference's modules/optimization_adamw.py).

  - per-group peak lr and weight decay (train/param_groups.py);
  - the schedule (`warmup_cosine` | `warmup_constant` | `warmup_linear`,
    lr_start / lr_end as fractions of the peak) is evaluated inside
    `step()` from the optimizer's own step counter, shared by all groups;
  - p ← p·(1 − lr_t·wd) − (lr_t/bc1)·m / (√v/√bc2 + eps), in fp32;
  - the moments are stored in `moment_dtype` (the math stays fp32).

Plain torch: the JAX optimizer is not a kernel. Frozen parameters are not
in the optimizer (requires_grad=False). A trainable parameter with no
gradient in a step is updated as with a zero gradient, as the JAX
transform, which sees a zero for it, does.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def warmup_cosine(x: float, warmup: float, lr_start=0.0, lr_end=0.0) -> float:
    if x < warmup:
        return x * (1.0 - lr_start) / warmup + lr_start
    new_x = (x - warmup) / (1.0 - warmup)
    return lr_end + 0.5 * (1.0 - lr_end) * (1.0 + math.cos(math.pi * new_x))


def warmup_constant(x: float, warmup: float, lr_start=0.0, lr_end=0.0) -> float:
    return x / warmup if x < warmup else 1.0


def warmup_linear(x: float, warmup: float, lr_start=0.0, lr_end=0.0) -> float:
    return x / warmup if x < warmup else max((x - 1.0) / (warmup - 1.0), 0.0)


SCHEDULES: Dict[str, Callable] = {
    "warmup_cosine": warmup_cosine,
    "warmup_constant": warmup_constant,
    "warmup_linear": warmup_linear,
}


class AdaptAdamW(torch.optim.Optimizer):
    """Every param group carries its `lr` (peak) and `weight_decay`; the
    shared step counter is `self.step_count`."""

    def __init__(self, params: Iterable, t_total: int, warmup: float = 0.15,
                 schedule: str = "warmup_cosine", b1: float = 0.9,
                 b2: float = 0.98, eps: float = 1e-6, lr_start: float = 0.0,
                 lr_end: float = 0.0, moment_dtype: str = "float32"):
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {sorted(SCHEDULES)}, "
                             f"got {schedule!r}")
        if moment_dtype not in DTYPES:
            raise ValueError(f"moment_dtype must be one of {sorted(DTYPES)}, "
                             f"got {moment_dtype!r}")
        super().__init__(params, {})
        for group in self.param_groups:
            if "lr" not in group or "weight_decay" not in group:
                raise ValueError("every parameter group needs its lr and weight_decay")
        self.t_total, self.warmup, self.schedule = t_total, warmup, schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.lr_start, self.lr_end = lr_start, lr_end
        self.moment_dtype = DTYPES[moment_dtype]
        self.step_count = 0

    def schedule_factor(self, step: int) -> float:
        if self.t_total <= 0:
            return 1.0
        return SCHEDULES[self.schedule](step / self.t_total, self.warmup,
                                        self.lr_start, self.lr_end)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdaptAdamW.step takes no closure")
        self.step_count += 1
        step = self.step_count
        bc1 = 1.0 - self.b1 ** step
        bc2 = 1.0 - self.b2 ** step
        sched = self.schedule_factor(step)
        for group in self.param_groups:
            lr_t = group["lr"] * sched
            wd = group["weight_decay"]
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p, dtype=self.moment_dtype)
                    state["exp_avg_sq"] = torch.zeros_like(p, dtype=self.moment_dtype)
                g = (torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                     else p.grad.float())
                m = state["exp_avg"].float().mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                v = state["exp_avg_sq"].float().mul_(self.b2).addcmul_(
                    g, g, value=1.0 - self.b2)
                denom = v.sqrt() / math.sqrt(bc2) + self.eps
                p32 = p.float()
                delta = -p32 * lr_t * wd - (lr_t / bc1) * m / denom
                p.copy_((p32 + delta).to(p.dtype))
                state["exp_avg"].copy_(m)
                state["exp_avg_sq"].copy_(v)
        return None


def global_norm_clip(params: Iterable[torch.nn.Parameter],
                     max_norm: float) -> torch.Tensor:
    """clip_grad_norm_ with the reference's formula: every gradient times
    min(1, max_norm / (‖g‖ + 1e-6)), ‖g‖ the fp32 global norm. Returns ‖g‖
    (a 0-d tensor on the gradients' device)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm
