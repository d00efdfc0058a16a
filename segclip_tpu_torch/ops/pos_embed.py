"""Position tables and the resolution interpolation of the learned visual
position embedding (segclip_tpu/ops/pos_embed.py).

`sincos_2d`, `sinusoid_table`, `interp_matrix` and `_cubic_kernel` are
numpy copies of the JAX package's (whose module imports jax):
  - the fixed 2D sin-cos table of the vision MAE decoder and the 1D
    sinusoid table (zero row 0) of the text MAE decoder;
  - cubic/linear interpolation matrices with torch F.interpolate's
    align_corners=False semantics (cubic A=−0.75, half-pixel centres,
    replicate border). A resize is two matmuls with these matrices, in fp32.
"""
from __future__ import annotations

import numpy as np
import torch


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(embed_dim: int, grid_size: int, cls_token: bool = False) -> np.ndarray:
    """MAE's fixed 2D sin-cos position table, (grid², D) fp32, with a zero
    CLS row first when `cls_token`."""
    if embed_dim % 4:
        raise ValueError(f"embed_dim {embed_dim} must be a multiple of 4")
    grid_w, grid_h = np.meshgrid(np.arange(grid_size, dtype=np.float32),
                                 np.arange(grid_size, dtype=np.float32))
    emb = np.concatenate([_sincos_1d(embed_dim // 2, grid_w.reshape(-1)),
                          _sincos_1d(embed_dim // 2, grid_h.reshape(-1))], axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros([1, embed_dim]), emb], axis=0)
    return emb.astype(np.float32)


def sinusoid_table(n_position: int, d_model: int) -> np.ndarray:
    """Interleaved sinusoid table with a zero row at position 0:
    angle[pos, i] = pos / 10000^(2i/d), sin on even and cos on odd
    channels."""
    i = np.arange(d_model, dtype=np.float64)
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    table = pos / np.power(10000.0, 2.0 * i / d_model)
    table[0, :] = 0.0
    table[1:, 0::2] = np.sin(table[1:, 0::2])
    table[1:, 1::2] = np.cos(table[1:, 1::2])
    return table.astype(np.float32)


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (Keys); torch's bicubic uses A=−0.75."""
    ax = np.abs(x)
    w = np.where(ax <= 1, (a + 2) * ax**3 - (a + 3) * ax**2 + 1,
                 np.where(ax < 2, a * ax**3 - 5 * a * ax**2 + 8 * a * ax - 4 * a,
                          0.0))
    return w


def interp_matrix(in_size: int, out_size: int, method: str = "cubic") -> np.ndarray:
    """(out_size, in_size) interpolation matrix, half-pixel centres,
    replicate border — torch align_corners=False semantics."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    t = src - base

    if method == "cubic":
        offsets = np.arange(-1, 3)
    elif method == "linear":
        offsets = np.arange(0, 2)
    else:
        raise ValueError(method)

    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for off in offsets:
        idx = np.clip(base + off, 0, in_size - 1)
        if method == "cubic":
            w = _cubic_kernel(t - off)
        else:
            w = np.clip(1.0 - np.abs(t - off), 0.0, None)
        np.add.at(mat, (np.arange(out_size), idx), w)
    return mat.astype(np.float32)


def interp_tensor(in_size: int, out_size: int, method: str,
                  device: torch.device) -> torch.Tensor:
    return torch.from_numpy(interp_matrix(in_size, out_size, method)).to(device)


def resize_2d(x: torch.Tensor, out_h: int, out_w: int,
              method: str = "cubic") -> torch.Tensor:
    """Resize (..., H, W, C) via two matmuls; fp32 accumulation."""
    h, w = x.shape[-3], x.shape[-2]
    mh = interp_tensor(h, out_h, method, x.device)
    mw = interp_tensor(w, out_w, method, x.device)
    y = torch.einsum("oh,...hwc->...owc", mh, x.float())
    y = torch.einsum("pw,...owc->...opc", mw, y)
    return y.to(x.dtype)


def interpolate_pos_embed(pos_embed: torch.Tensor, out_h: int,
                          out_w: int) -> torch.Tensor:
    """Bicubic-resize a learned (1+N, D) visual position embedding to a new
    grid: the CLS row passes through; the N patch rows are reshaped to the
    square grid, resized and flattened again."""
    n = pos_embed.shape[0] - 1
    side = int(round(n ** 0.5))
    if out_h == side and out_w == side:
        return pos_embed
    cls_row, patch = pos_embed[:1], pos_embed[1:]
    grid = patch.reshape(side, side, -1)
    resized = resize_2d(grid, out_h, out_w, method="cubic")
    return torch.cat([cls_row, resized.reshape(out_h * out_w, -1)], dim=0)
