"""Train-time image transforms on the device (segclip_tpu/ops/device_aug.py):
the bicubic crop-resize of the device-augmentation transport, the YCbCr
4:2:0 → RGB reconstruction of the yuv420 transport, and the superpixel
patch reduction.

None of these is a kernel in the JAX package (it is `jnp` code inside the
jitted step), so they stay plain PyTorch here: batched float32 matrix
products, `F.interpolate` and elementwise ops, on whatever device their
inputs are on.

Crop-resize. The host ships the decoded image padded into a fixed
(S, Wmax, 3) uint8 canvas plus integer crop-window coordinates; the step
computes per-sample PIL-semantics bicubic resampling weights and applies
them as two matrix products:

    out[o, p, c] = sum_h sum_w Rv[o, h] * canvas[h, w, c] * Rh[p, w]

Weight semantics follow PIL's ImagingResample (antialiased bicubic,
a = -0.5): per output pixel the source center is win0 + (o + 0.5) * scale,
the kernel is evaluated at (tap + 0.5 - center) / filterscale with
filterscale = max(scale, 1), taps limited to [int(center - support + .5),
int(center + support + .5)) clamped to the crop window, and each row of
weights normalized to sum 1. PIL also quantizes its weights to 8.22 fixed
point, which a float path does not reproduce: the result is within one
uint8 level of PIL (tests/test_torch_device_aug.py).

PIL materializes a rounded, clipped uint8 intermediate after its first
(horizontal) pass, and the bicubic lobes overshoot [0, 255], so both
passes round and clip. Tall images are shipped TRANSPOSED (with swapped
window coordinates); for them the canvas-vertical pass runs first, since
the intermediate's clipping breaks transpose symmetry. The products must
run in true float32: TF32 moves values across the rounding boundaries, so
on CUDA the crop-resize raises when TF32 matmuls are enabled
(`utils/device.resolve_device` turns them off).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

BICUBIC_A = -0.5
SUPPORT = 2.0                     # PIL bicubic filter support


def _bicubic_kernel(x: torch.Tensor) -> torch.Tensor:
    """PIL's bicubic filter (a = -0.5), vectorized."""
    a = BICUBIC_A
    ax = x.abs()
    w1 = ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
    w2 = (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a
    return torch.where(ax < 1.0, w1, torch.where(ax < 2.0, w2, torch.zeros_like(ax)))


def resample_matrix(canvas_size: int, out_size: int, win0: torch.Tensor,
                    win_len: torch.Tensor) -> torch.Tensor:
    """(..., out_size, canvas_size) float32 PIL-bicubic resampling weights
    for one axis, on win0's device.

    win0/win_len: integer tensors of any shape (..., ) — the crop window
    [win0, win0 + win_len) inside the canvas, one per leading index. Rows
    are normalized to sum 1 (PIL's per-pixel coefficient normalization).
    """
    win0 = win0.to(torch.float32)[..., None, None]
    win_len = win_len.to(torch.float32)[..., None, None]
    scale = win_len / out_size
    filterscale = torch.clamp(scale, min=1.0)
    support = SUPPORT * filterscale

    o = torch.arange(out_size, dtype=torch.float32, device=win0.device)[:, None]
    center = win0 + (o + 0.5) * scale
    taps = torch.arange(canvas_size, dtype=torch.float32, device=win0.device)[None, :]

    w = _bicubic_kernel((taps + 0.5 - center) / filterscale)
    # PIL tap range: [int(center - support + .5), int(center + support + .5))
    # clamped to the window — a mask over the dense tap axis.
    lo = torch.maximum(torch.floor(center - support + 0.5), win0)
    hi = torch.minimum(torch.floor(center + support + 0.5), win0 + win_len)
    w = torch.where((taps >= lo) & (taps < hi), w, torch.zeros_like(w))
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-8)


def _clip8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even (as jnp.round) and clip to the uint8 range."""
    return torch.clamp(torch.round(x), 0.0, 255.0)


def _crop_resize(canvas: torch.Tensor, window: torch.Tensor, out_size: int,
                 vertical_first: Optional[torch.Tensor]) -> torch.Tensor:
    """canvas (B, H, W, 3) uint8, window (B, 4) (j, i, w, h) → (B, out,
    out, 3) float32: horizontal pass first, or, where `vertical_first` is
    set, the vertical pass first (both orders are computed and selected per
    sample, as the JAX function does)."""
    if canvas.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("crop_resize needs float32 matrix products: TF32 is enabled "
                           "(torch.backends.cuda.matmul.allow_tf32); "
                           "utils.device.resolve_device turns it off")
    b, h_canvas, w_canvas, _ = canvas.shape
    j, i, w, h = window.unbind(-1)
    rv = resample_matrix(h_canvas, out_size, i, h)                 # (B, out, H)
    rh_t = resample_matrix(w_canvas, out_size, j, w).transpose(1, 2)   # (B, W, out)
    img = canvas.to(torch.float32)                                 # (B, H, W, 3)

    # horizontal first: (B, H·3, W) @ (B, W, out), then (B, out, H) @ (B, H, 3·out)
    tmp = _clip8(torch.bmm(img.permute(0, 1, 3, 2).reshape(b, h_canvas * 3, w_canvas),
                           rh_t))                                  # (B, H·3, out)
    out = _clip8(torch.bmm(rv, tmp.reshape(b, h_canvas, 3 * out_size)))
    out = out.reshape(b, out_size, 3, out_size).permute(0, 1, 3, 2)
    if vertical_first is None:
        return out
    # vertical first: (B, out, H) @ (B, H, W·3), then (B, out·3, W) @ (B, W, out)
    tmp = _clip8(torch.bmm(rv, img.reshape(b, h_canvas, w_canvas * 3)))
    tmp = tmp.reshape(b, out_size, w_canvas, 3).permute(0, 1, 3, 2)
    out_v = _clip8(torch.bmm(tmp.reshape(b, out_size * 3, w_canvas), rh_t))
    out_v = out_v.reshape(b, out_size, 3, out_size).permute(0, 1, 3, 2)
    return torch.where(vertical_first.to(torch.bool)[:, None, None, None], out_v, out)


def crop_resize_one(canvas: torch.Tensor, window: torch.Tensor, out_size: int,
                    vertical_first: Optional[torch.Tensor] = None) -> torch.Tensor:
    """canvas (H, W, 3) uint8, window (4,) integer (j, i, w, h) →
    (out_size, out_size, 3) float32 in [0, 255]. `vertical_first` (a 0-d
    flag) runs the canvas-vertical pass first where set (transposed
    canvases)."""
    vf = None if vertical_first is None else vertical_first.reshape(1)
    return _crop_resize(canvas[None], window[None], out_size, vf)[0]


def crop_resize_batch(canvas: torch.Tensor, window: torch.Tensor,
                      transposed: torch.Tensor, out_size: int) -> torch.Tensor:
    """Batched crop-resize with per-sample untranspose.

    canvas (B, S, Wmax, 3) uint8; window (B, 4) integer (j, i, w, h) in
    canvas coordinates (already swapped for transposed samples);
    transposed (B,) {0, 1}. Returns (B, out_size, out_size, 3) float32
    pixels in [0, 255].
    """
    out = _crop_resize(canvas, window, out_size, transposed)
    return torch.where(transposed.to(torch.bool)[:, None, None, None],
                       out.transpose(1, 2), out)


def yuv420_to_rgb(y: torch.Tensor, cbcr: torch.Tensor) -> torch.Tensor:
    """Device-side inverse of data.transforms.rgb_to_yuv420.

    y: (B, H, W) uint8; cbcr: (B, H/2, W/2, 2) uint8 → (B, H, W, 3) float32
    pixels in [0, 255], not rounded. Chroma is upsampled bilinearly
    (half-pixel centers, edge pixels repeated: jax.image.resize's "linear"
    at 2×) and converted with the exact JFIF inverse matrix.
    """
    b, h, w = y.shape
    c = cbcr.permute(0, 3, 1, 2).to(torch.float32) - 128.0
    c = F.interpolate(c, size=(h, w), mode="bilinear", align_corners=False)
    cb, cr = c[:, 0], c[:, 1]
    yf = y.to(torch.float32)
    r = yf + 1.402 * cr
    g = yf - 0.344136 * cb - 0.714136 * cr
    bch = yf + 1.772 * cb
    return torch.clamp(torch.stack([r, g, bch], dim=-1), 0.0, 255.0)


def _patch_reduce(seg_canvas: torch.Tensor, window: torch.Tensor, img_size: int,
                  patch: int) -> torch.Tensor:
    """(B, H, W) ids, (B, 4) windows → (B, g, g) int32, g = img_size // patch."""
    b = seg_canvas.shape[0]
    j, i, w, h = window.to(torch.int64).unbind(-1)
    d = torch.arange(img_size, device=seg_canvas.device)
    # torch F.interpolate(mode='nearest'): src = floor(dst * in / out)
    ys = i[:, None] + (d * h[:, None]) // img_size
    xs = j[:, None] + (d * w[:, None]) // img_size
    rows = torch.arange(b, device=seg_canvas.device)[:, None, None]
    resized = seg_canvas[rows, ys[:, :, None], xs[:, None, :]].to(torch.int64)
    g = img_size // patch
    sums = resized.reshape(b, g, patch, g, patch).sum(dim=(2, 4))
    return (sums // (patch * patch)).to(torch.int32)


def superpixel_patch_reduce_one(seg_canvas: torch.Tensor, window: torch.Tensor,
                                img_size: int, patch: int) -> torch.Tensor:
    """Device equivalent of data/superpixel.crop_seg_from_cache (no-flip
    path): nearest-resize the window to img_size² then integer-mean ids
    per (patch × patch) tile. seg_canvas (H, W) integer; window (4,)
    (j, i, w, h). Returns (img_size // patch,)² int32."""
    return _patch_reduce(seg_canvas[None], window[None], img_size, patch)[0]


def superpixel_patch_reduce_batch(seg_canvas: torch.Tensor, window: torch.Tensor,
                                  transposed: torch.Tensor, img_size: int,
                                  patch: int) -> torch.Tensor:
    out = _patch_reduce(seg_canvas, window, img_size, patch)
    return torch.where(transposed.to(torch.bool)[:, None, None], out.transpose(1, 2), out)
