"""AdaptAdamW: AdamW with the LR schedule inside the step and the weight
decay applied before the update (segclip_tpu/train/optimizer.py, itself the
reference's modules/optimization_adamw.py).

  - per-group peak lr and weight decay (train/param_groups.py);
  - the schedule (`warmup_cosine` | `warmup_constant` | `warmup_linear`,
    lr_start / lr_end as fractions of the peak) is evaluated inside
    `step()` from the optimizer's own step counter, shared by all groups;
  - p ← p·(1 − lr_t·wd) − (lr_t/bc1)·m / (√v/√bc2 + eps), in fp32;
  - the moments are stored in `moment_dtype` (the math stays fp32).

Two paths, chosen by the leaves' device. CUDA leaves take the multi-tensor
kernels of csrc/adamw.cu (ops/kernels/adamw.py): the clip is its norm's
partial sums, a finalize and a scale, the update one more launch, at any
number of leaves (up to 512 of one dtype a launch), with the norm and the
scale kept on the card; a dtype or layout they do not take raises. CPU
leaves take the plain path, a loop of ATen ops per leaf (`adamw_plain`,
`global_norm_clip_plain`), the kernels' reference: the same fp32 arithmetic
in the same order. Frozen parameters are not in the optimizer
(requires_grad=False). A trainable parameter with no gradient in a step is
updated as with a zero gradient, as the JAX transform, which sees a zero
for it, does.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable

import torch

from segclip_tpu_torch.ops.kernels import adamw as kernels
from segclip_tpu_torch.parallel.dist import all_reduce_

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
    shared step counter is `self.step_count`. On a card the step is one
    launch of the update kernel (ops/kernels/adamw.py) over the leaves of
    `kernel_leaves()`, built once the state exists."""

    _leaves = None              # kernel_leaves(), until the groups or the state are replaced

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

    def add_param_group(self, param_group: dict) -> None:
        super().add_param_group(param_group)
        self._leaves = None

    def load_state_dict(self, state_dict: dict) -> None:
        """Optimizer.load_state_dict, the moments then cast back to
        `moment_dtype` (it casts them to their parameter's dtype) and made
        contiguous (a checkpoint's tensors may be views of another layout,
        which the update kernel does not read)."""
        super().load_state_dict(state_dict)
        for state in self.state.values():
            for key in ("exp_avg", "exp_avg_sq"):
                if key in state:
                    state[key] = state[key].to(self.moment_dtype).contiguous()
        self._leaves = None

    def schedule_factor(self, step: int) -> float:
        if self.t_total <= 0:
            return 1.0
        return SCHEDULES[self.schedule](step / self.t_total, self.warmup,
                                        self.lr_start, self.lr_end)

    def init_state(self, p: torch.Tensor) -> dict:
        """p's state, its two moments made (zeros in moment_dtype) if it
        has none yet."""
        state = self.state[p]
        if not state:
            state["exp_avg"] = torch.zeros_like(p, dtype=self.moment_dtype)
            state["exp_avg_sq"] = torch.zeros_like(p, dtype=self.moment_dtype)
        return state

    def kernel_leaves(self) -> kernels.AdamWLeaves:
        """The update kernel's leaves: every parameter in group order, with
        its state (made where missing) and its group's index."""
        if self._leaves is None:
            params = [(p, i) for i, group in enumerate(self.param_groups)
                      for p in group["params"]]
            self._leaves = kernels.AdamWLeaves([p for p, _ in params],
                                               [self.init_state(p) for p, _ in params],
                                               [i for _, i in params])
        return self._leaves

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdaptAdamW.step takes no closure")
        self.step_count += 1
        step = self.step_count
        bc1 = 1.0 - self.b1 ** step
        bc2 = 1.0 - self.b2 ** step
        sched = self.schedule_factor(step)
        first = next((p for group in self.param_groups for p in group["params"]), None)
        if first is None:
            return None
        if _plain(first.device):
            adamw_plain(self, bc1, bc2, sched)
        else:
            kernels.multi_tensor_adamw(
                self.kernel_leaves(), [group["lr"] * sched for group in self.param_groups],
                [group["weight_decay"] for group in self.param_groups],
                bc1, bc2, self.b1, self.b2, self.eps)
        return None


def _plain(device: torch.device) -> bool:
    """Whether leaves on `device` take the plain path (the CPU) rather than
    the kernels (a CUDA card)."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cpu"


def adamw_plain(optimizer: AdaptAdamW, bc1: float, bc2: float, sched: float) -> None:
    """One AdaptAdamW step, leaf by leaf in ATen ops (the CPU's path, and
    the kernel's reference): bc1 = 1 − b1^t, bc2 = 1 − b2^t, sched the
    schedule's factor at step t."""
    o = optimizer
    for group in o.param_groups:
        lr_t = group["lr"] * sched
        wd = group["weight_decay"]
        for p in group["params"]:
            state = o.init_state(p)
            g = (torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                 else p.grad.float())
            m = state["exp_avg"].float().mul_(o.b1).add_(g, alpha=1.0 - o.b1)
            v = state["exp_avg_sq"].float().mul_(o.b2).addcmul_(
                g, g, value=1.0 - o.b2)
            denom = v.sqrt() / math.sqrt(bc2) + o.eps
            p32 = p.float()
            delta = -p32 * lr_t * wd - (lr_t / bc1) * m / denom
            p.copy_((p32 + delta).to(p.dtype))
            state["exp_avg"].copy_(m)
            state["exp_avg_sq"].copy_(v)


def global_norm_clip(params: Iterable[torch.nn.Parameter],
                     max_norm: float, model_group=None) -> torch.Tensor:
    """clip_grad_norm_ with the reference's formula: every gradient times
    min(1, max_norm / (‖g‖ + 1e-6)), ‖g‖ the fp32 global norm. Returns ‖g‖
    (a 0-d tensor on the gradients' device).

    Under tensor parallelism (`model_group`, the model row; None without
    one, parallel/dist.model_group()) the squares of
    the sharded gradients (parameters with `model_shard`,
    parallel/gspmd.py) are summed over the row once, and the replicated
    ones, equal on every rank, count once: the norm of the full gradient,
    as JAX's global norm of the sharded tree.

    On a card: the multi-tensor kernels (ops/kernels/adamw.py), the norm
    and the scale never leaving the card; on the CPU
    `global_norm_clip_plain`."""
    params = [p for p in params if p.grad is not None]
    if not params:
        return torch.zeros(())
    if _plain(params[0].device):
        return global_norm_clip_plain(params, max_norm, model_group)
    sharded = None if model_group is None else [hasattr(p, "model_shard") for p in params]
    table = kernels.GradTable([p.grad for p in params], sharded)
    out = kernels.multi_tensor_norm(
        table, max_norm, None if model_group is None else lambda s: all_reduce_(s, model_group))
    kernels.multi_tensor_scale(table, out)
    return out[kernels.NORM]


def global_norm_clip_plain(params: Iterable[torch.nn.Parameter],
                           max_norm: float, model_group=None) -> torch.Tensor:
    """`global_norm_clip` leaf by leaf in ATen ops (the CPU's path, and the
    kernels' reference)."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    if not grads:
        return torch.zeros(())
    if model_group is None:
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    else:
        sums = [torch.zeros((), device=grads[0].device) for _ in range(2)]
        for p in params:
            sums[hasattr(p, "model_shard")] += p.grad.float().square().sum()
        replicated, sharded = sums
        norm = torch.sqrt(all_reduce_(sharded, model_group) + replicated)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm
