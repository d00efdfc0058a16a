"""Attention forward over (B, L, H·64) operands: the CUDA kernel
`csrc/attention_fwd.cu` and its plain PyTorch version.

Replaces the TPU kernel `_fwd_kernel` of segclip_tpu/ops/pallas/attention.py
(`attention_vmem` forward). What bounds it on the H100 and what the design
does about it is in the header of the CUDA source: at SegCLIP's lengths
(≤ ~300 tokens) the call is small and latency-bound, so the kernel keeps the
score matrix on chip and reads the q|k|v column views of the packed
projection in place (a row stride per operand), with no head transpose and
no copy.

`attention` takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import torch

from segclip_tpu_torch.kernels import build

HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         bias: Optional[torch.Tensor] = None,
         scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ·scale + bias) v over (B, H, L, Dh), plain torch, with the
    kernel's dtype chain: fp32 logits and softmax, P cast to v's dtype, P·V
    summed in fp32, output in v's dtype. scale defaults to Dh**−0.5."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias2d: Optional[torch.Tensor] = None,
                    biasb: Optional[torch.Tensor] = None,
                    scale: float = HEAD_DIM ** -0.5) -> torch.Tensor:
    """The plain version of `attention`: `sdpa` per 64-dim head on the
    (B, L, H·64) operands, with bias2d + biasb as its bias."""
    bias = None
    if bias2d is not None:
        bias = bias2d.float()
    if biasb is not None:
        bb = biasb.float()[:, None, None, :]
        bias = bb if bias is None else bias + bb
    heads = q.shape[-1] // HEAD_DIM
    return _merge_heads(sdpa(_split_heads(q, heads), _split_heads(k, heads),
                             _split_heads(v, heads), bias, scale))


@lru_cache(maxsize=None)
def _entry():
    fn = build.load().segclip_attention_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 6 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, bias2d, biasb):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (B, L, H·64)")
    b, lq, dm = q.shape
    lk = k.shape[1]
    if k.shape != (b, lk, dm) or v.shape != (b, lk, dm):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if dm % HEAD_DIM or dm == 0:
        raise ValueError(f"model dim {dm} is not a multiple of head dim "
                         f"{HEAD_DIM}")
    if b == 0 or lq == 0 or lk == 0:
        raise ValueError("empty attention operand")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must share dtype float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if bias2d is not None and (bias2d.shape != (lq, lk)
                               or bias2d.dtype != torch.float32):
        raise ValueError(f"bias2d must be float32 ({lq}, {lk}), got "
                         f"{bias2d.dtype} {tuple(bias2d.shape)}")
    if biasb is not None and (biasb.shape != (b, lk)
                              or biasb.dtype != torch.float32):
        raise ValueError(f"biasb must be float32 ({b}, {lk}), got "
                         f"{biasb.dtype} {tuple(biasb.shape)}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias2d: Optional[torch.Tensor] = None,
              biasb: Optional[torch.Tensor] = None,
              scale: float = HEAD_DIM ** -0.5) -> torch.Tensor:
    """Fused attention over (B, L, H·64) operands, no head transpose.

    bias2d: optional (Lq, Lk) fp32 additive bias (the causal mask, −inf
    allowed); biasb: optional (B, Lk) fp32 additive bias (padding rows).
    Each of q, k, v may be a column view with its own row stride (the last
    dim must be unit-stride). Returns a contiguous (B, Lq, H·64) tensor in
    v's dtype.
    """
    _check(q, k, v, bias2d, biasb)
    tensors = [t for t in (q, k, v, bias2d, biasb) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    device = q.device
    if device.type == "cpu":
        return attention_plain(q, k, v, bias2d, biasb, scale)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")

    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a unit stride on the last dim")
    bias2d = None if bias2d is None else bias2d.contiguous()
    biasb = None if biasb is None else biasb.contiguous()
    b, lq, dm = q.shape
    lk = k.shape[1]
    out = torch.empty((b, lq, dm), dtype=v.dtype, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _entry()(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias2d is None else bias2d.data_ptr(),
            None if biasb is None else biasb.data_ptr(), out.data_ptr(),
            b, dm // HEAD_DIM, lq, lk,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), float(scale), stream)
    build.check(err, "attention_fwd")
    attention.launches += 1
    return out


attention.launches = 0
