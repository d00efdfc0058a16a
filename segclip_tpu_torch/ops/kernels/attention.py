"""Attention over (B, L, H·64) operands: the CUDA kernels
`csrc/attention_fwd.cu`, `csrc/attention_fwd_long.cu`,
`csrc/attention_fwd_tf32x3.cu` (forward), `csrc/attention_bwd.cu`,
`csrc/attention_bwd_tf32x3.cu` and `csrc/attention_bwd_long.cu` (backward),
their plain PyTorch versions, and the autograd Function that joins them.

Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
segclip_tpu/ops/pallas/attention.py (`attention_vmem` and its custom VJP).
What bounds them on the H100 and what their design does about it is in the
headers of the CUDA sources: at bfloat16 the kernels run their products on
tensor cores and are bound by the bytes of Q, K, V, dO and the saved P;
they read the q|k|v column views of the packed projection in place (a row
stride per operand), with no head transpose and no copy. The float32
forward and backward run fp32-accurate split products on TF32 tensor
cores (`csrc/attention_{fwd,bwd}_tf32x3.cu`, `csrc/attention_bwd_long.cu`:
three TF32 products per fp32 product, as PyTorch's float32 SDPA computes
them).

The forward has four routes, and `fwd_route` picks one by dtype and Lk
alone: bfloat16 rows of at most ONE_PASS_LIMIT keys (every row of the B = 96
step and of the 224×224 request) go to the one-pass kernel (TMA copies,
`wgmma`, whole score rows on chip); bf16 rows of up to CLUSTER_LIMIT keys
(448 px's 784 and 792, ViT-L/14's cross 264, a 224×336 request's 294) to
the cluster kernel (one thread-block cluster per (batch, head), each block
one slab of keys, the row statistics and O summed through distributed
shared memory); longer bf16 rows, from LONG_MIN_LK keys on (a 448×672
request's 1176 and 1184, a 224×2048 request's 1792 and 1800), to the long
kernel ("long": two passes over 64-key pieces streamed by TMA, two
warpgroups per 64-row query tile, four for one-tile rows, `wgmma`); every float32 row, of any
length (float32 eval, the float32 step, the drift replay), to the TF32x3
kernel ("tf32x3"). Nothing falls back: a launch that fails raises.
`attention.launches` counts every forward launch, and
`attention_fwd_one_pass.launches`, `attention_fwd_cluster.launches`,
`attention_fwd_long.launches` and `attention_fwd_tf32x3.launches` each
route's; those four functions launch their kernel directly.
`attention_fwd_two_pass` launches the two-pass kernels (bf16 on `mma.sync`,
float32 on FMAs) directly, with its own counter: no route reaches them, and
chip_smoke.py times them beside the routes' kernels.

The backward has five routes, and `bwd_route` picks one by dtype and Lk
alone: bfloat16 rows of at most BWD_ONE_PASS_LIMIT keys (every backward of
the B = 96 and B = 512 steps) go to the one-pass kernel (one block per
(batch, head), dK and dV summed on chip, TMA copies, `wgmma`); bf16 rows of
up to BWD_CLUSTER_LIMIT keys to the cluster kernel (the one-pass design
over a cluster: each block one key slab's dK and dV, D and dQ summed
through distributed shared memory); longer bf16 rows, from BWD_LONG_MIN_LK
keys on (a 672 px step's 1764 and 1772), to the long kernels ("long": a row
pass for D and dQ per 64-row query tile, then a slab pass for dK and dV per
128-key slab, D through a scratch, `wgmma`, TMA); float32 rows of up to
BWD_TF32X3_LIMIT keys (every float32 backward of the B = 96 step, the
drift replay) to the TF32x3 kernel ("tf32x3": a cluster per (batch, head)
over 64-key slabs, TF32 `wgmma`, TMA); longer float32 rows (ViT-L/14's
cross 264, a float32 448 px step's 784 and 792) to the TF32x3 long kernels
("tf32x3_long": the long route's two passes on TF32 `wgmma`).
`attention_bwd.launches` counts every backward call, and
`attention_bwd_one_pass.launches`, `attention_bwd_cluster.launches`,
`attention_bwd_long.launches`, `attention_bwd_tf32x3.launches` and
`attention_bwd_tf32x3_long.launches` each route's; those five functions
launch their kernels directly (a long route's call is two launches, counted
once). `attention_bwd_two_pass` launches the two-pass kernels (the bf16
pair on `mma.sync`, the float32 SIMT pair) directly, with its own counter:
no route reaches them, and chip_smoke.py times them beside the routes'
kernels.

`attention` is differentiable on every device. Under autograd its forward
saves P (B, H, Lq, Lk) in V's dtype and its backward starts from that P, as
the TPU kernel's VJP does. On the card P is a view of a (B, H, Lq, Lk8)
buffer, Lk8 = Lk rounded up to 8, so every row starts on 16 bytes; the
backward reads it through its strides, without a copy. Each wrapper
takes its plain version only for tensors on the CPU; for CUDA tensors it
launches a kernel or raises.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import torch

from segclip_tpu_torch.kernels import build

HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The longest rows (Lk) the bf16 one-pass kernel takes: ONE_PASS_LIMIT of
# csrc/attention_fwd.cu, which the library reports (`one_pass_limit`).
ONE_PASS_LIMIT = 256
# The same for the bf16 one-pass backward: BWD_ONE_PASS_LIMIT of
# csrc/attention_bwd.cu (`bwd_one_pass_limit`).
BWD_ONE_PASS_LIMIT = 256
# The longest rows the bf16 cluster kernels take: CLUSTER_LIMIT of
# csrc/attention_fwd.cu and BWD_CLUSTER_LIMIT of csrc/attention_bwd.cu,
# which the library reports (`cluster_limit`, `bwd_cluster_limit`).
CLUSTER_LIMIT = 1024
BWD_CLUSTER_LIMIT = 1024
# The shortest bf16 rows the long kernel takes: LONG_MIN_LK of
# csrc/attention_fwd_long.cu, which the library reports (`long_min_lk`).
LONG_MIN_LK = 1025
# The longest float32 rows the TF32x3 backward takes: BWD_TF32X3_LIMIT of
# csrc/attention_bwd_tf32x3.cu (`bwd_tf32x3_limit`).
BWD_TF32X3_LIMIT = 256
# The shortest rows the long backward kernels take: BWD_LONG_MIN_LK (bf16)
# and BWD_TF32X3_LONG_MIN_LK (float32) of csrc/attention_bwd_long.cu, which
# the library reports (`bwd_long_min_lk("long")`, `bwd_long_min_lk("tf32x3_long")`).
BWD_LONG_MIN_LK = 1025
BWD_TF32X3_LONG_MIN_LK = 257


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


def _sdpa_with_probs(q, k, v, bias, scale):
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype), probs


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         bias: Optional[torch.Tensor] = None,
         scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ·scale + bias) v over (B, H, L, Dh), plain torch, with the
    kernel's dtype chain: fp32 logits and softmax, P cast to v's dtype, P·V
    summed in fp32, output in v's dtype. scale defaults to Dh**−0.5."""
    return _sdpa_with_probs(q, k, v, bias, scale)[0]


def _joint_bias(bias2d, biasb):
    bias = None
    if bias2d is not None:
        bias = bias2d.float()
    if biasb is not None:
        bb = biasb.float()[:, None, None, :]
        bias = bb if bias is None else bias + bb
    return bias


def attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias2d: Optional[torch.Tensor] = None,
                        biasb: Optional[torch.Tensor] = None,
                        scale: float = HEAD_DIM ** -0.5
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the forward kernel: (out (B, Lq, H·64) in v's
    dtype, P (B, H, Lq, Lk) in v's dtype), `sdpa` per 64-dim head with
    bias2d + biasb as its bias."""
    heads = q.shape[-1] // HEAD_DIM
    out, probs = _sdpa_with_probs(split_heads(q, heads), split_heads(k, heads),
                                  split_heads(v, heads),
                                  _joint_bias(bias2d, biasb), scale)
    return merge_heads(out), probs


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias2d: Optional[torch.Tensor] = None,
                    biasb: Optional[torch.Tensor] = None,
                    scale: float = HEAD_DIM ** -0.5) -> torch.Tensor:
    """The plain version of `attention`'s value: `sdpa` per 64-dim head on
    the (B, L, H·64) operands, with bias2d + biasb as its bias."""
    return attention_fwd_plain(q, k, v, bias2d, biasb, scale)[0]


def attention_bwd_plain(p: torch.Tensor, do: torch.Tensor, q: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor,
                        scale: float = HEAD_DIM ** -0.5
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the backward kernel, the formulas of
    segclip_tpu/ops/pallas/attention.py:96-120 in fp32 from the saved P
    (B, H, Lq, Lk): dV = PᵀdO; dP = dO·Vᵀ; dS = P∘(dP − rowsum(dP∘P));
    dQ = dS·K·scale; dK = dSᵀ·Q·scale. Returns (dQ, dK, dV) in the dtypes
    of q, k and v."""
    heads = q.shape[-1] // HEAD_DIM
    pf = p.float()
    dof, qf, kf, vf = (split_heads(t, heads).float() for t in (do, q, k, v))
    dv = torch.matmul(pf.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = pf * (dp - (dp * pf).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return (merge_heads(dq).to(q.dtype), merge_heads(dk).to(k.dtype),
            merge_heads(dv).to(v.dtype))


@lru_cache(maxsize=None)
def _fwd_entry():
    fn = build.load().segclip_attention_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _one_pass_entry():
    fn = build.load().segclip_attention_fwd_one_pass
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def one_pass_limit() -> int:
    """The longest Lk the one-pass kernel takes, as the library reports it
    (`segclip_attention_fwd_one_pass_limit`); ONE_PASS_LIMIT mirrors it."""
    fn = build.load().segclip_attention_fwd_one_pass_limit
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


@lru_cache(maxsize=None)
def _cluster_entry():
    fn = build.load().segclip_attention_fwd_cluster
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def cluster_limit() -> int:
    """The longest Lk the cluster kernel takes, as the library reports it
    (`segclip_attention_fwd_cluster_limit`); CLUSTER_LIMIT mirrors it."""
    fn = build.load().segclip_attention_fwd_cluster_limit
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


@lru_cache(maxsize=None)
def _tf32x3_entry():
    fn = build.load().segclip_attention_fwd_tf32x3
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _long_entry():
    fn = build.load().segclip_attention_fwd_long
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def long_min_lk() -> int:
    """The shortest Lk the bf16 long kernel takes, as the library reports it
    (`segclip_attention_fwd_long_min_lk`); LONG_MIN_LK mirrors it."""
    fn = build.load().segclip_attention_fwd_long_min_lk
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def division_check(p: torch.Tensor, l: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels' branch-free division (hopper.cuh `div_normal`)
    and IEEE p / l on the card, for float32 CUDA tensors p and l of one
    shape: (fast, ieee). chip_smoke.py holds the two equal over the range of
    l the kernels meet."""
    if (p.shape != l.shape or {p.dtype, l.dtype} != {torch.float32}
            or p.device.type != "cuda" or l.device != p.device):
        raise ValueError("p and l must be float32 CUDA tensors of one shape")
    fn = build.load().segclip_attention_division_check
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    p, l = p.contiguous(), l.contiguous()
    fast, ieee = torch.empty_like(p), torch.empty_like(p)
    with torch.cuda.device(p.device):
        build.check(fn(p.data_ptr(), l.data_ptr(), fast.data_ptr(), ieee.data_ptr(), p.numel(),
                       torch._C._cuda_getCurrentRawStream(p.device.index)), "division check")
    return fast, ieee


def fwd_route(dtype: torch.dtype, lk: int, limit: int = ONE_PASS_LIMIT,
              cluster: int = CLUSTER_LIMIT) -> str:
    """Which forward kernel takes a call on the card, by its dtype and Lk
    alone: "one_pass" for bfloat16 rows of at most `limit` keys, "cluster"
    for bf16 rows of up to `cluster` keys, "long" for longer bf16 rows, and
    "tf32x3" for every float32 row."""
    if dtype == torch.float32:
        return "tf32x3"
    return "one_pass" if lk <= limit else "cluster" if lk <= cluster else "long"


@lru_cache(maxsize=None)
def cluster_shape(direction: str, lk: int, batch_heads: int,
                  device: int) -> Tuple[int, int, int, int]:
    """The cluster the "fwd" or "bwd" cluster kernel launches for rows of lk
    keys over batch·heads (batch, head) rows on CUDA card `device`: (blocks,
    keys per block's slab, bytes of shared memory per block, clusters the
    card holds at once). Raises if cudaOccupancyMaxActiveClusters says none
    can be resident."""
    fn = getattr(build.load(), f"segclip_attention_{direction}_cluster_shape")
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong] + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(4)]
    with torch.cuda.device(device):
        build.check(fn(lk, batch_heads, *out), f"attention_{direction} (cluster shape)")
    blocks, slab, smem, active = (x.value for x in out)
    if active < 1:
        raise RuntimeError(
            f"attention_{direction} (cluster) at Lk = {lk}: cudaOccupancyMaxActiveClusters "
            f"says no cluster of {blocks} blocks with {smem} bytes of shared memory each "
            f"can be resident on {torch.cuda.get_device_name(device)}")
    return blocks, slab, smem, active


@lru_cache(maxsize=None)
def _bwd_entry():
    fn = build.load().segclip_attention_bwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 11 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _bwd_one_pass_entry():
    fn = build.load().segclip_attention_bwd_one_pass
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 11 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def bwd_one_pass_limit() -> int:
    """The longest Lk the one-pass backward takes, as the library reports
    it (`segclip_attention_bwd_one_pass_limit`); BWD_ONE_PASS_LIMIT mirrors
    it."""
    fn = build.load().segclip_attention_bwd_one_pass_limit
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


@lru_cache(maxsize=None)
def _bwd_cluster_entry():
    fn = build.load().segclip_attention_bwd_cluster
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 11 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def bwd_cluster_limit() -> int:
    """The longest Lk the cluster backward takes, as the library reports it
    (`segclip_attention_bwd_cluster_limit`); BWD_CLUSTER_LIMIT mirrors it."""
    fn = build.load().segclip_attention_bwd_cluster_limit
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


@lru_cache(maxsize=None)
def _bwd_tf32x3_entry():
    fn = build.load().segclip_attention_bwd_tf32x3
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 11 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def bwd_tf32x3_limit() -> int:
    """The longest Lk the float32 TF32x3 backward takes, as the library
    reports it (`segclip_attention_bwd_tf32x3_limit`); BWD_TF32X3_LIMIT
    mirrors it."""
    fn = build.load().segclip_attention_bwd_tf32x3_limit
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


@lru_cache(maxsize=None)
def _bwd_long_entry(route: str):
    fn = getattr(build.load(), f"segclip_attention_bwd_{route}")
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 11 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def bwd_long_min_lk(route: str = "long") -> int:
    """The shortest Lk the "long" (bf16) or "tf32x3_long" (float32) backward
    takes, as the library reports it (`segclip_attention_bwd_<route>_min_lk`);
    BWD_LONG_MIN_LK and BWD_TF32X3_LONG_MIN_LK mirror them."""
    fn = getattr(build.load(), f"segclip_attention_bwd_{route}_min_lk")
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def bwd_route(dtype: torch.dtype, lk: int, limit: int = BWD_ONE_PASS_LIMIT,
              cluster: int = BWD_CLUSTER_LIMIT, tf32x3: int = BWD_TF32X3_LIMIT) -> str:
    """Which backward kernel takes a call on the card, by its dtype and Lk
    alone: "one_pass" for bfloat16 rows of at most `limit` keys, "cluster"
    for bf16 rows of up to `cluster` keys, "long" for longer bf16 rows,
    "tf32x3" for float32 rows of up to `tf32x3` keys and "tf32x3_long" for
    longer float32 rows."""
    if dtype == torch.float32:
        return "tf32x3" if lk <= tf32x3 else "tf32x3_long"
    return "one_pass" if lk <= limit else "cluster" if lk <= cluster else "long"


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


def _device_of(*tensors) -> torch.device:
    """The one device of the given tensors (None entries skipped): the CPU
    or a CUDA card; anything else raises."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def _unit_last_stride(*tensors) -> None:
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("q, k, v (and dO) need a unit stride on the last dim")


def _aligned16(t: torch.Tensor) -> bool:
    """Whether the bf16 and TF32x3 kernels' 16-byte copies (`cp.async`, TMA)
    can read `t`: a unit last stride, and its base and the strides of every
    dim longer than 1 multiples of 16 bytes."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * size % 16 == 0
                    for n, st in zip(t.shape[:-1], t.stride()[:-1]) if n > 1))


def _check_aligned(*tensors) -> None:
    if any(not _aligned16(t) for t in tensors):
        dtype = tensors[0].dtype
        raise ValueError(f"{str(dtype)[6:]} q, k, v need 16-byte aligned bases and row "
                         f"and batch strides (multiples of {16 // tensors[0].element_size()} "
                         "elements)")


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


def _kernel_p(p: torch.Tensor, tma: Optional[bool] = None) -> torch.Tensor:
    """P as the backward kernels read it: the forward's padded view goes in
    as it is; another layout is copied into one (the kernels that copy P
    by TMA, `tma`, by default every bf16 kernel: rows padded to 8 elements,
    batch and head dims one dim of stride H·Lq·rows; the SIMT pair: a unit
    last stride)."""
    b, heads = p.shape[:2]
    one_bh = b == 1 or heads == 1 or p.stride(0) == heads * p.stride(1)
    if tma is None:
        tma = p.dtype == torch.bfloat16
    if tma and not (_aligned16(p) and one_bh):
        padded = torch.zeros((*p.shape[:-1], _round8(p.shape[-1])), dtype=p.dtype,
                             device=p.device)
        padded[..., :p.shape[-1]] = p
        return padded[..., :p.shape[-1]]
    return p if p.stride(-1) == 1 else p.contiguous()


def _kernel_do(do: torch.Tensor, tma: Optional[bool] = None) -> torch.Tensor:
    """dO as the backward kernel reads it: a dO the kernels that copy by TMA
    (`tma`, by default every bf16 kernel) cannot read (the expanded
    cotangent of a sum, an offset view) is copied into fresh storage; the
    SIMT pair needs a unit last stride."""
    if tma is None:
        tma = do.dtype == torch.bfloat16
    ok = _aligned16(do) if tma else do.stride(-1) == 1
    return do if ok else do.clone(memory_format=torch.contiguous_format)


def _launch_fwd(route, q, k, v, bias2d, biasb, scale, save_p):
    """One launch of a forward kernel on CUDA tensors (checked): "one_pass"
    (`segclip_attention_fwd_one_pass`, bf16, Lk ≤ the limit), "cluster"
    (`segclip_attention_fwd_cluster`, bf16, the limit < Lk ≤ the cluster
    limit), "long" (`segclip_attention_fwd_long`, bf16, Lk ≥ its lower
    limit), "tf32x3" (`segclip_attention_fwd_tf32x3`, float32, any Lk) or
    "two_pass" (`segclip_attention_fwd`). Returns (out, P or None). The
    training step
    is host-bound, so the stream comes as a raw handle and the device is
    switched only when the tensors are not on the current one."""
    device = q.device
    _unit_last_stride(q, k, v)
    if q.dtype == torch.bfloat16 or route == "tf32x3":
        _check_aligned(q, k, v)
    bias2d = None if bias2d is None else bias2d.contiguous()
    biasb = None if biasb is None else biasb.contiguous()
    b, lq, dm = q.shape
    lk = k.shape[1]
    heads = dm // HEAD_DIM
    if route == "one_pass":
        if q.dtype != torch.bfloat16 or lk > one_pass_limit():
            raise ValueError(f"the one-pass kernel takes bfloat16 rows of at most "
                             f"{one_pass_limit()} keys, got {q.dtype}, Lk = {lk}")
        entry, dtype = _one_pass_entry(), ()
    elif route == "cluster":
        if q.dtype != torch.bfloat16 or not one_pass_limit() < lk <= cluster_limit():
            raise ValueError(f"the cluster kernel takes bfloat16 rows of {one_pass_limit() + 1} "
                             f"to {cluster_limit()} keys, got {q.dtype}, Lk = {lk}")
        cluster_shape("fwd", lk, b * heads, device.index)
        entry, dtype = _cluster_entry(), ()
    elif route == "long":
        if q.dtype != torch.bfloat16 or lk < long_min_lk():
            raise ValueError(f"the long kernel takes bfloat16 rows of at least "
                             f"{long_min_lk()} keys, got {q.dtype}, Lk = {lk}")
        entry, dtype = _long_entry(), ()
    elif route == "tf32x3":
        if q.dtype != torch.float32:
            raise ValueError(f"the TF32x3 kernel takes float32 rows, got {q.dtype}")
        entry, dtype = _tf32x3_entry(), ()
    else:
        entry, dtype = _fwd_entry(), (_DTYPES[q.dtype],)
    out = torch.empty((b, lq, dm), dtype=v.dtype, device=device)
    p = (torch.empty((b, heads, lq, _round8(lk)), dtype=v.dtype,
                     device=device).narrow(3, 0, lk) if save_p else None)
    p_strides = p.stride()[:3] if save_p else (0, 0, 0)
    args = (*dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias2d is None else bias2d.data_ptr(),
            None if biasb is None else biasb.data_ptr(), out.data_ptr(),
            None if p is None else p.data_ptr(), b, heads, lq, lk,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), *p_strides, float(scale),
            torch._C._cuda_getCurrentRawStream(device.index))
    if device.index == torch.cuda.current_device():
        err = entry(*args)
    else:
        with torch.cuda.device(device):
            err = entry(*args)
    build.check(err, f"attention_fwd ({route})")
    return out, p


def _fwd_route_call(route, q, k, v, bias2d, biasb, scale, save_p):
    _check(q, k, v, bias2d, biasb)
    if _device_of(q, k, v, bias2d, biasb).type == "cpu":
        out, p = attention_fwd_plain(q, k, v, bias2d, biasb, scale)
        return out, (p if save_p else None)
    out, p = _launch_fwd(route, q, k, v, bias2d, biasb, scale, save_p)
    _ROUTES[route].launches += 1
    return out, p


def attention_fwd_one_pass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias2d: Optional[torch.Tensor] = None,
                           biasb: Optional[torch.Tensor] = None,
                           scale: float = HEAD_DIM ** -0.5, save_p: bool = False
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The bf16 one-pass forward kernel alone (Lk ≤ the limit; it raises on
    anything else), as `attention_fwd` returns; the plain version on the
    CPU. `attention_fwd` routes to it; chip_smoke.py times it directly."""
    return _fwd_route_call("one_pass", q, k, v, bias2d, biasb, scale, save_p)


def attention_fwd_cluster(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias2d: Optional[torch.Tensor] = None,
                          biasb: Optional[torch.Tensor] = None,
                          scale: float = HEAD_DIM ** -0.5, save_p: bool = False
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The bf16 cluster forward kernel alone (the one-pass limit < Lk ≤ the
    cluster limit; it raises on anything else), as `attention_fwd` returns;
    the plain version on the CPU. `attention_fwd` routes to it;
    chip_smoke.py times it directly."""
    return _fwd_route_call("cluster", q, k, v, bias2d, biasb, scale, save_p)


def attention_fwd_long(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias2d: Optional[torch.Tensor] = None,
                       biasb: Optional[torch.Tensor] = None,
                       scale: float = HEAD_DIM ** -0.5, save_p: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The bf16 long-row forward kernel alone (Lk ≥ its lower limit; it
    raises on anything else), as `attention_fwd` returns; the plain version
    on the CPU. `attention_fwd` routes to it; chip_smoke.py times it
    directly."""
    return _fwd_route_call("long", q, k, v, bias2d, biasb, scale, save_p)


def attention_fwd_tf32x3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias2d: Optional[torch.Tensor] = None,
                         biasb: Optional[torch.Tensor] = None,
                         scale: float = HEAD_DIM ** -0.5, save_p: bool = False
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The float32 TF32x3 forward kernel alone (any Lk; it raises on
    bfloat16), as `attention_fwd` returns; the plain version on the CPU.
    `attention_fwd` routes to it; chip_smoke.py times it directly."""
    return _fwd_route_call("tf32x3", q, k, v, bias2d, biasb, scale, save_p)


def attention_fwd_two_pass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias2d: Optional[torch.Tensor] = None,
                           biasb: Optional[torch.Tensor] = None,
                           scale: float = HEAD_DIM ** -0.5, save_p: bool = False
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The two-pass forward kernels alone (PR 3's bf16 kernel on
    `mma.sync`, PR 1's float32 kernel on FMAs; any Lk), as `attention_fwd`
    returns; the plain version on the CPU. No route of `attention_fwd`
    reaches them; chip_smoke.py times them beside the routes' kernels."""
    return _fwd_route_call("two_pass", q, k, v, bias2d, biasb, scale, save_p)


_ROUTES = {"one_pass": attention_fwd_one_pass, "cluster": attention_fwd_cluster,
           "long": attention_fwd_long, "tf32x3": attention_fwd_tf32x3,
           "two_pass": attention_fwd_two_pass}


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias2d: Optional[torch.Tensor] = None,
                  biasb: Optional[torch.Tensor] = None,
                  scale: float = HEAD_DIM ** -0.5, save_p: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The forward kernels' wrapper: (out (B, Lq, H·64) contiguous in v's
    dtype, P (B, H, Lq, Lk) in v's dtype if `save_p` else None; on the card
    P is the view [..., :Lk] of a (B, H, Lq, Lk8) buffer). On the card the
    call goes to the kernel `fwd_route` names for its dtype and Lk, with
    the library's limits. Not differentiable itself; `attention` is."""
    _check(q, k, v, bias2d, biasb)
    device = _device_of(q, k, v, bias2d, biasb)
    if device.type == "cpu":
        out, p = attention_fwd_plain(q, k, v, bias2d, biasb, scale)
        return out, (p if save_p else None)
    bf16 = q.dtype == torch.bfloat16
    route = (fwd_route(q.dtype, k.shape[1], one_pass_limit(), cluster_limit()) if bf16
             else fwd_route(q.dtype, k.shape[1]))
    out, p = _launch_fwd(route, q, k, v, bias2d, biasb, scale, save_p)
    _ROUTES[route].launches += 1
    attention.launches += 1
    return out, p


def _check_bwd(p, do, q, k, v) -> torch.device:
    """Checks the backward's operands; returns their one device."""
    _check(q, k, v, None, None)
    b, lq, dm = q.shape
    lk = k.shape[1]
    heads = dm // HEAD_DIM
    if p.shape != (b, heads, lq, lk) or p.dtype != v.dtype:
        raise ValueError(f"P must be {v.dtype} {(b, heads, lq, lk)}, got "
                         f"{p.dtype} {tuple(p.shape)}")
    if do.shape != q.shape or do.dtype != v.dtype:
        raise ValueError(f"dO must be {v.dtype} {tuple(q.shape)}, got "
                         f"{do.dtype} {tuple(do.shape)}")
    return _device_of(p, do, q, k, v)


def _launch_bwd(route, p, do, q, k, v, scale):
    """One call of a backward route on CUDA tensors (checked): "one_pass"
    (`segclip_attention_bwd_one_pass`, bf16, Lk ≤ the limit), "cluster"
    (`segclip_attention_bwd_cluster`, bf16, the limit < Lk ≤ the cluster
    limit), "long" (`segclip_attention_bwd_long`, bf16, Lk ≥ its lower
    limit), "tf32x3" (`segclip_attention_bwd_tf32x3`, float32, Lk ≤ its
    limit), "tf32x3_long" (`segclip_attention_bwd_tf32x3_long`, float32, Lk ≥
    its lower limit) or "two_pass" (`segclip_attention_bwd`); the last three
    with a (B, H, Lq4) fp32 D scratch. Returns (dQ, dK, dV). As
    `_launch_fwd`: a raw stream handle, and the device switched only when
    the tensors are not on the current one."""
    device = q.device
    _unit_last_stride(q, k, v)
    tma = q.dtype == torch.bfloat16 or route in ("tf32x3", "tf32x3_long")
    if tma:
        _check_aligned(q, k, v)
    b, lq, dm = q.shape
    lk = k.shape[1]
    heads = dm // HEAD_DIM
    if route == "tf32x3" and (q.dtype != torch.float32 or lk > bwd_tf32x3_limit()):
        raise ValueError(f"the TF32x3 backward takes float32 rows of at most "
                         f"{bwd_tf32x3_limit()} keys, got {q.dtype}, Lk = {lk}")
    if route == "one_pass" and (q.dtype != torch.bfloat16 or lk > bwd_one_pass_limit()):
        raise ValueError(f"the one-pass backward takes bfloat16 rows of at most "
                         f"{bwd_one_pass_limit()} keys, got {q.dtype}, Lk = {lk}")
    if route == "cluster":
        if q.dtype != torch.bfloat16 or not bwd_one_pass_limit() < lk <= bwd_cluster_limit():
            raise ValueError(f"the cluster backward takes bfloat16 rows of "
                             f"{bwd_one_pass_limit() + 1} to {bwd_cluster_limit()} keys, got "
                             f"{q.dtype}, Lk = {lk}")
        cluster_shape("bwd", lk, b * heads, device.index)
    if route in ("long", "tf32x3_long"):
        dtype = torch.bfloat16 if route == "long" else torch.float32
        if q.dtype != dtype or lk < bwd_long_min_lk(route):
            raise ValueError(f"the {route} backward takes {str(dtype)[6:]} rows of at least "
                             f"{bwd_long_min_lk(route)} keys, got {q.dtype}, Lk = {lk}")
    p, do = _kernel_p(p, tma), _kernel_do(do, tma)
    dq = torch.empty((b, lq, dm), dtype=q.dtype, device=device)
    dk = torch.empty((b, lk, dm), dtype=k.dtype, device=device)
    dv = torch.empty((b, lk, dm), dtype=v.dtype, device=device)
    ptrs = (p.data_ptr(), do.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    rest = (*p.stride()[:3], do.stride(0), do.stride(1), q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), v.stride(0), v.stride(1), float(scale),
            torch._C._cuda_getCurrentRawStream(device.index))
    if route in ("one_pass", "cluster", "tf32x3"):
        entry = {"one_pass": _bwd_one_pass_entry, "cluster": _bwd_cluster_entry,
                 "tf32x3": _bwd_tf32x3_entry}[route]()
        args = (*ptrs, b, heads, lq, lk, *rest)
    else:
        drow = torch.empty((b, heads, (lq + 3) // 4 * 4), dtype=torch.float32,
                           device=device)
        if route == "two_pass":
            entry, args = _bwd_entry(), (_DTYPES[q.dtype], *ptrs, drow.data_ptr(), b, heads,
                                         lq, lk, *rest)
        else:
            entry = _bwd_long_entry(route)
            args = (*ptrs, drow.data_ptr(), b, heads, lq, lk, *rest)
    if device.index == torch.cuda.current_device():
        err = entry(*args)
    else:
        with torch.cuda.device(device):
            err = entry(*args)
    build.check(err, f"attention_bwd ({route})")
    return dq, dk, dv


def _bwd_route_call(route, p, do, q, k, v, scale):
    if _check_bwd(p, do, q, k, v).type == "cpu":
        return attention_bwd_plain(p, do, q, k, v, scale)
    grads = _launch_bwd(route, p, do, q, k, v, scale)
    _BWD_ROUTES[route].launches += 1
    return grads


def attention_bwd_one_pass(p: torch.Tensor, do: torch.Tensor, q: torch.Tensor,
                           k: torch.Tensor, v: torch.Tensor,
                           scale: float = HEAD_DIM ** -0.5
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 one-pass backward kernel alone (Lk ≤ the limit; it raises
    on anything else), as `attention_bwd` returns; the plain version on the
    CPU. `attention_bwd` routes to it; chip_smoke.py times it directly."""
    return _bwd_route_call("one_pass", p, do, q, k, v, scale)


def attention_bwd_cluster(p: torch.Tensor, do: torch.Tensor, q: torch.Tensor,
                          k: torch.Tensor, v: torch.Tensor,
                          scale: float = HEAD_DIM ** -0.5
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 cluster backward kernel alone (the one-pass limit < Lk ≤ the
    cluster limit; it raises on anything else), as `attention_bwd` returns;
    the plain version on the CPU. `attention_bwd` routes to it;
    chip_smoke.py times it directly."""
    return _bwd_route_call("cluster", p, do, q, k, v, scale)


def attention_bwd_long(p: torch.Tensor, do: torch.Tensor, q: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor,
                       scale: float = HEAD_DIM ** -0.5
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 long-row backward kernels alone (Lk ≥ their lower limit; it
    raises on anything else), as `attention_bwd` returns; the plain version
    on the CPU. `attention_bwd` routes to it; chip_smoke.py times it
    directly."""
    return _bwd_route_call("long", p, do, q, k, v, scale)


def attention_bwd_tf32x3(p: torch.Tensor, do: torch.Tensor, q: torch.Tensor,
                         k: torch.Tensor, v: torch.Tensor,
                         scale: float = HEAD_DIM ** -0.5
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The float32 TF32x3 backward kernel alone (Lk ≤ its limit; it raises
    on anything else), as `attention_bwd` returns; the plain version on the
    CPU. `attention_bwd` routes to it; chip_smoke.py times it directly."""
    return _bwd_route_call("tf32x3", p, do, q, k, v, scale)


def attention_bwd_tf32x3_long(p: torch.Tensor, do: torch.Tensor, q: torch.Tensor,
                              k: torch.Tensor, v: torch.Tensor,
                              scale: float = HEAD_DIM ** -0.5
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The float32 TF32x3 long-row backward kernels alone (Lk ≥ their lower
    limit; it raises on anything else), as `attention_bwd` returns; the
    plain version on the CPU. `attention_bwd` routes to it; chip_smoke.py
    times it directly."""
    return _bwd_route_call("tf32x3_long", p, do, q, k, v, scale)


def attention_bwd_two_pass(p: torch.Tensor, do: torch.Tensor, q: torch.Tensor,
                           k: torch.Tensor, v: torch.Tensor,
                           scale: float = HEAD_DIM ** -0.5
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two-pass backward kernels alone (the bf16 pair on `mma.sync`, the
    float32 SIMT pair on FMAs; any Lk), as `attention_bwd` returns; the
    plain version on the CPU. No route of `attention_bwd` reaches them;
    chip_smoke.py times them beside the routes' kernels."""
    return _bwd_route_call("two_pass", p, do, q, k, v, scale)


_BWD_ROUTES = {"one_pass": attention_bwd_one_pass, "cluster": attention_bwd_cluster,
               "long": attention_bwd_long, "tf32x3": attention_bwd_tf32x3,
               "tf32x3_long": attention_bwd_tf32x3_long, "two_pass": attention_bwd_two_pass}


def attention_bwd(p: torch.Tensor, do: torch.Tensor, q: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor,
                  scale: float = HEAD_DIM ** -0.5
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' wrapper: (dQ, dK, dV) from the saved P, the
    output's cotangent dO (B, Lq, H·64) and the operands, each contiguous
    in its operand's dtype. P is read through its strides (the forward's
    padded view without a copy); a dO the kernels cannot read in place is
    copied first. On the card the call goes to the kernel `bwd_route` names
    for its dtype and Lk, with the library's limits."""
    if _check_bwd(p, do, q, k, v).type == "cpu":
        return attention_bwd_plain(p, do, q, k, v, scale)
    bf16 = q.dtype == torch.bfloat16
    route = (bwd_route(q.dtype, k.shape[1], bwd_one_pass_limit(), bwd_cluster_limit()) if bf16
             else bwd_route(q.dtype, k.shape[1], tf32x3=bwd_tf32x3_limit()))
    grads = _launch_bwd(route, p, do, q, k, v, scale)
    _BWD_ROUTES[route].launches += 1
    attention_bwd.launches += 1
    return grads


class AttentionFn(torch.autograd.Function):
    """The forward kernel with P saved, and the backward kernel from that P
    (the custom VJP of segclip_tpu/ops/pallas/attention.py:217-247). The
    biases are masks and get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias2d, biasb, scale):
        out, p = attention_fwd(q, k, v, bias2d, biasb, scale, save_p=True)
        ctx.save_for_backward(p, q, k, v)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        p, q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_bwd(p, do, q, k, v, ctx.scale)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias2d: Optional[torch.Tensor] = None,
              biasb: Optional[torch.Tensor] = None,
              scale: float = HEAD_DIM ** -0.5) -> torch.Tensor:
    """Fused attention over (B, L, H·64) operands, no head transpose,
    differentiable in q, k and v.

    bias2d: optional (Lq, Lk) fp32 additive bias (the causal mask, −inf
    allowed); biasb: optional (B, Lk) fp32 additive bias (padding rows).
    Each of q, k, v may be a column view with its own row stride (the last
    dim must be unit-stride). Returns a contiguous (B, Lq, H·64) tensor in
    v's dtype. P is saved only when a gradient can be asked for.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return AttentionFn.apply(q, k, v, bias2d, biasb, scale)
    return attention_fwd(q, k, v, bias2d, biasb, scale)[0]


attention.launches = 0          # forward kernel launches, every route
attention_fwd_one_pass.launches = 0     # forward launches of the one-pass kernel
attention_fwd_cluster.launches = 0      # forward launches of the cluster kernel
attention_fwd_long.launches = 0         # forward launches of the bf16 long-row kernel
attention_fwd_tf32x3.launches = 0       # forward launches of the float32 TF32x3 kernel
attention_fwd_two_pass.launches = 0     # direct launches of the two-pass kernels (no route)
attention_bwd.launches = 0      # backward kernel launches, every route
attention_bwd_one_pass.launches = 0     # backward launches of the one-pass kernel
attention_bwd_cluster.launches = 0      # backward launches of the cluster kernel
attention_bwd_long.launches = 0         # backward calls of the bf16 long-row kernels
attention_bwd_tf32x3.launches = 0       # backward launches of the float32 TF32x3 kernel
attention_bwd_tf32x3_long.launches = 0  # backward calls of the float32 TF32x3 long-row kernels
attention_bwd_two_pass.launches = 0     # direct calls of the two-pass kernels (no route)
