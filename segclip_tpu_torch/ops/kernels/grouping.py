"""Semantic group assignment, eval path: the CUDA kernel
`csrc/group_assign.cu` and its plain PyTorch version.

Replaces the TPU kernel `_kernel` of segclip_tpu/ops/pallas/grouping.py with
training=False (`fused_group_assign`). At eval sizes (G=8 groups over 196
patches of width 768 per image) the call moves well under a megabyte and is
latency-bound; the kernel spreads it over many blocks in two passes — an
assignment pass over (image, 8 patches) and a gather-sum over (image, 64
columns), since the assignment is one-hot — with only the winning group of
each patch in between (details in the CUDA source).

`group_assign` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

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


@lru_cache(maxsize=None)
def _entry():
    fn = build.load().segclip_group_assign
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
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


def group_assign(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deterministic (eval) grouping, as `group_assign_plain`. On CUDA, q, k
    and v must be contiguous."""
    _check(q, k, v)
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    device = q.device
    if device.type == "cpu":
        return group_assign_plain(q, k, v)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")

    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("group_assign needs contiguous q, k, v on CUDA")
    n, g, d = q.shape
    l = k.shape[1]
    if n > 65535:
        raise ValueError(f"N={n} images exceed one launch's grid (65535)")
    if 4 * g * d > SMEM_LIMIT:
        raise ValueError(f"G·D too large: q takes {4 * g * d} bytes of shared "
                         f"memory > {SMEM_LIMIT}")
    out = torch.empty((n, g, d), dtype=v.dtype, device=device)
    hard = torch.empty((n, g, l), dtype=torch.float32, device=device)
    soft = torch.empty((n, g, l), dtype=torch.float32, device=device)
    winner = torch.empty((n, l), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _entry()(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), hard.data_ptr(),
                       soft.data_ptr(), winner.data_ptr(), n, g, l, d, stream)
    build.check(err, "group_assign")
    group_assign.launches += 1
    return out, hard, soft


group_assign.launches = 0
