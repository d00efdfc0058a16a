"""Semantic group assignment: the CUDA kernel `csrc/group_assign.cu` (eval
and Gumbel straight-through forward), its plain PyTorch versions, and the
autograd Function with the straight-through backward.

Replaces the TPU kernel `_kernel` of segclip_tpu/ops/pallas/grouping.py,
reached through `fused_group_assign` (training=False) and
`fused_group_assign_st` (training=True, whose VJP `_st_bwd` is jnp, and is
plain torch here). One launch per call, with a cluster of 8 blocks per
image that share the winners through distributed shared memory; at bf16
the logits and hard·v run on tensor cores, and q, k and v move in 16-byte
pieces (details in the CUDA source).

`group_assign` (eval) and `group_assign_st` (training) are differentiable
on every device; each takes the plain version only for tensors on the CPU,
and for CUDA tensors launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import torch

from segclip_tpu_torch.kernels import build
from segclip_tpu_torch.ops.grouping import group_assign_aggregate

G_MAX = 32
SMEM_LIMIT = 232448            # bytes of shared memory one H100 block can use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def group_assign_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (N, G, D); k, v (N, L, D) → (out (N, G, D) in v's dtype,
    hard (N, G, L) fp32 one-hot over G, soft (N, G, L) fp32).

    logits = q·kᵀ in fp32, then `group_assign_aggregate` at eval: soft =
    softmax over G, hard = one-hot argmax of soft (lowest index on ties),
    out = hard·v / max(Σ_L hard, 1) in fp32."""
    logits = torch.matmul(q.float(), k.float().transpose(1, 2))   # (N, G, L)
    return group_assign_aggregate(logits, v, tau=1.0, training=False)


def group_assign_st_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          noise: torch.Tensor, tau: float
                          ) -> Tuple[torch.Tensor, ...]:
    """The training form: (out, hard, soft, y_soft), with y_soft =
    softmax over G of (q·kᵀ + noise) / tau and hard its one-hot argmax;
    `group_assign_aggregate(training=True, gumbel_noise=noise)` on fp32
    q·kᵀ."""
    logits = torch.matmul(q.float(), k.float().transpose(1, 2))
    out, hard, soft = group_assign_aggregate(logits, v, tau=tau, training=True,
                                             gumbel_noise=noise)
    y_soft = torch.softmax((logits + noise.float()) / tau, dim=1)
    return out, hard, soft, y_soft


def group_assign_st_bwd(q, k, v, hard, soft, y_soft, out, tau: float,
                        d_out, d_hard, d_soft):
    """The straight-through VJP, line by line from `_st_bwd`
    (segclip_tpu/ops/pallas/grouping.py:178-211), in fp32: hard's cotangent
    (plus ḡ·vᵀ and the count term) flows through the softmax that gave
    y_soft, divided by tau; soft's through the plain softmax; the count
    normaliser max(c, 1) passes 1 / 0.5 / 0 for c > 1 / c == 1 / c < 1, as
    jnp.maximum's subgradient does. Returns (dq, dk, dv)."""
    f32 = torch.float32
    hard32, v32, out32 = hard.to(f32), v.to(f32), out.to(f32)
    d_out32 = d_out.to(f32)

    c = hard32.sum(dim=-1, keepdim=True)                        # (B, G, 1)
    n = torch.maximum(c, torch.ones_like(c))
    g_bar = d_out32 / n
    dmax = torch.where(c > 1.0, 1.0, torch.where(c == 1.0, 0.5, 0.0))
    c_bar = -(d_out32 * out32).sum(dim=-1, keepdim=True) / n * dmax

    hard_bar = d_hard.to(f32) + torch.matmul(g_bar, v32.transpose(1, 2)) + c_bar
    v_bar = torch.matmul(hard32.transpose(1, 2), g_bar)

    z_bar = (hard_bar - (hard_bar * y_soft).sum(dim=1, keepdim=True)) * y_soft
    l_bar = z_bar / tau
    s = d_soft.to(f32)
    l_bar = l_bar + (s - (s * soft).sum(dim=1, keepdim=True)) * soft

    q_bar = torch.matmul(l_bar, k.to(f32))
    k_bar = torch.matmul(l_bar.transpose(1, 2), q.to(f32))
    return q_bar.to(q.dtype), k_bar.to(k.dtype), v_bar.to(v.dtype)


@lru_cache(maxsize=None)
def _entry():
    fn = build.load().segclip_group_assign
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _limits(dtype: int, vec: bool, g: int, l: int, d: int) -> Tuple[int, int]:
    """(bytes of shared memory per block, clusters of 8 such blocks the
    card holds at once) for a call at these sizes, from the kernel's own
    layout and `cudaOccupancyMaxActiveClusters`."""
    fn = build.load().segclip_group_assign_limits
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    smem, clusters = ctypes.c_longlong(), ctypes.c_int()
    build.check(fn(dtype, int(vec), g, l, d, ctypes.byref(smem), ctypes.byref(clusters)),
                "group_assign limits")
    return smem.value, clusters.value


def vector_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernel takes its 16-byte path (tensor-core logits at
    bf16): D a multiple of 16 bytes and q, k, v 16-byte aligned. Otherwise
    it takes its general path, in the same launch."""
    return (q.shape[-1] * q.element_size() % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def _check(q, k, v, noise):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q must be (N, G, D); k and v (N, L, D)")
    n, g, d = q.shape
    l = k.shape[1]
    if k.shape != (n, l, d) or v.shape != (n, l, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if n == 0 or l == 0 or d == 0 or not 1 <= g <= G_MAX:
        raise ValueError(f"need N, L, D ≥ 1 and 1 ≤ G ≤ {G_MAX}, got "
                         f"N={n} G={g} L={l} D={d}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must share dtype float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if noise is not None and (noise.shape != (n, g, l)
                              or noise.dtype != torch.float32):
        raise ValueError(f"noise must be float32 {(n, g, l)}, got "
                         f"{noise.dtype} {tuple(noise.shape)}")
    devices = {t.device for t in (q, k, v, noise) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    device = q.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def group_assign_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     noise: Optional[torch.Tensor] = None, tau: float = 1.0
                     ) -> Tuple[torch.Tensor, ...]:
    """The kernel's wrapper: (out, hard, soft, y_soft). noise None is the
    eval form (y_soft = soft, tau unused; counted in
    `group_assign.launches`); with noise it is the training form (counted
    in `group_assign_st.launches`). Not differentiable itself. On CUDA, q,
    k, v and the noise must be contiguous."""
    device = _check(q, k, v, noise)
    if device.type == "cpu":
        if noise is None:
            out, hard, soft = group_assign_plain(q, k, v)
            return out, hard, soft, soft
        return group_assign_st_plain(q, k, v, noise, tau)

    if not all(t.is_contiguous() for t in (q, k, v, noise) if t is not None):
        raise ValueError("group_assign needs contiguous q, k, v, noise on CUDA")
    if noise is not None and not tau > 0:
        raise ValueError(f"tau must be positive, got {tau}")
    n, g, d = q.shape
    l = k.shape[1]
    if n > 65535:
        raise ValueError(f"N={n} images exceed one launch's grid (65535)")
    dtype, vec = _DTYPES[q.dtype], vector_path(q, k, v)
    with torch.cuda.device(device):
        smem, clusters = _limits(dtype, vec, g, l, d)
        if smem > SMEM_LIMIT:
            raise ValueError(f"G={g}, L={l}, D={d} need {smem} bytes of shared "
                             f"memory per block > {SMEM_LIMIT}")
        if clusters < 1:
            raise ValueError(f"no cluster of 8 blocks with {smem} bytes of shared "
                             "memory each fits on the card")
        out = torch.empty((n, g, d), dtype=v.dtype, device=device)
        hard = torch.empty((n, g, l), dtype=torch.float32, device=device)
        soft = torch.empty((n, g, l), dtype=torch.float32, device=device)
        y_soft = soft if noise is None else torch.empty_like(soft)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _entry()(dtype, int(vec), q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), None if noise is None else noise.data_ptr(),
                       float(tau), out.data_ptr(), hard.data_ptr(),
                       soft.data_ptr(),
                       None if noise is None else y_soft.data_ptr(),
                       n, g, l, d, stream)
    build.check(err, "group_assign")
    if noise is None:
        group_assign.launches += 1
    else:
        group_assign_st.launches += 1
    return out, hard, soft, y_soft


class GroupAssignST(torch.autograd.Function):
    """The kernel's forward and the straight-through backward of
    `_st_bwd` (plain torch, as the JAX VJP is jnp)."""

    @staticmethod
    def forward(ctx, q, k, v, noise, tau):
        out, hard, soft, y_soft = group_assign_fwd(q, k, v, noise, tau)
        ctx.save_for_backward(q, k, v, hard, soft, y_soft, out)
        ctx.tau = 1.0 if noise is None else tau
        return out, hard, soft

    @staticmethod
    def backward(ctx, d_out, d_hard, d_soft):
        q, k, v, hard, soft, y_soft, out = ctx.saved_tensors
        dq, dk, dv = group_assign_st_bwd(q, k, v, hard, soft, y_soft, out,
                                         ctx.tau, d_out, d_hard, d_soft)
        return dq, dk, dv, None, None


def _apply(q, k, v, noise, tau):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return GroupAssignST.apply(q, k, v, noise, tau)
    return group_assign_fwd(q, k, v, noise, tau)[:3]


def group_assign(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deterministic (eval) grouping, as `group_assign_plain`:
    (out, hard, soft). Differentiable like the JAX eval path (a plain
    softmax through the straight-through estimator): the training form
    with noise 0 and tau 1. On CUDA, q, k and v must be contiguous."""
    return _apply(q, k, v, None, 1.0)


def group_assign_st(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    noise: torch.Tensor, tau: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gumbel straight-through grouping for training, as
    `fused_group_assign_st`: noise is Gumbel(0, 1) of shape (N, G, L),
    float32. Returns (out, hard, soft); gradients are those of autodiff
    through `group_assign_aggregate(training=True)`."""
    return _apply(q, k, v, noise, tau)


group_assign.launches = 0       # eval-form kernel launches
group_assign_st.launches = 0    # training-form (Gumbel) kernel launches
