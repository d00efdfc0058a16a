"""MAE-style per-sample random masking by argsort of noise
(segclip_tpu/ops/masking.py).

Uniform noise per position; kept positions (CLS, and each row's EOT with
`keep_sep`) are pinned to −1 so they sort first; the lowest-noise `len_keep`
positions are kept. Both sorts are stable (`stable=True`), as `jnp.argsort`
is: with CLS and EOT both pinned, the tie between the two −1 entries goes
to the lower position, so `ids_shuffle` equals the JAX package's. EOT is
pinned per row — the documented intent, not the reference's row-0 scatter
(see the JAX module's note).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def random_masking(x: torch.Tensor, mask_ratio: float,
                   generator: Optional[torch.Generator] = None,
                   keep_cls: bool = False, keep_sep: bool = False,
                   sep_pos: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (N, L, D) → (x_masked (N, len_keep, D), mask (N, L) in x's dtype
    with 0 = keep and 1 = removed in the original order, ids_restore (N, L)
    the inverse permutation, ids_keep (N, len_keep)). `noise` (N, L)
    overrides the draw from `generator` (tests hand both frameworks the
    same noise)."""
    n, length, d = x.shape
    len_keep = int(length * (1 - mask_ratio))
    if noise is None:
        noise = torch.rand((n, length), generator=generator, device=x.device)
    noise = noise.to(device=x.device, dtype=torch.float32).clone()
    if keep_cls:
        noise[:, 0] = -1.0
    if keep_sep:
        if sep_pos is None:
            raise ValueError("keep_sep requires sep_pos")
        noise.scatter_(1, sep_pos.long().reshape(n, 1), -1.0)

    ids_shuffle = torch.argsort(noise, dim=1, stable=True)     # small = keep
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    x_masked = torch.gather(x, 1, ids_keep[:, :, None].expand(n, len_keep, d))

    mask = torch.ones((n, length), dtype=x.dtype, device=x.device)
    mask[:, :len_keep] = 0
    mask = torch.gather(mask, 1, ids_restore)
    return x_masked, mask, ids_restore, ids_keep
