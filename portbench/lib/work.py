"""The yardstick's arithmetic: the H100's peaks, the least time a piece of
work could take on it, the operations and bytes of the attention and
grouping calls that one step or one crop batch makes (a copy of the
counting rules of the program's ops/kernels/bounds.py, kept here so that
the program cannot change them), and the model FLOPs of a forward.

Peaks are NVIDIA's dense figures for one H100 SXM at 700 W: 3.35 TB/s of
HBM3, 989 TFLOP/s for bf16 products on tensor cores, and for float32
495 / 3 = 165 TFLOP/s (an fp32-accurate product on tensor cores takes three
TF32 products at 495 TFLOP/s).

Attention counts are of the function, not of a kernel: the forward reads
Q, K, V (and the fp32 biases), writes O and, under autograd, P; QKᵀ and
P·V. The backward reads P, dO, Q, K, V, writes dQ, dK, dV; four products.
Grouping reads q, k, v, writes the groups and the (N, G, L) fp32 hard and
soft maps (training adds the noise read and y_soft written); q·kᵀ and
hard·v.
"""
from __future__ import annotations

from typing import Iterable, List, NamedTuple, Tuple

from portbench.reference.model import Sizes

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
HEAD_DIM = 64
_ELEMENT = {"bfloat16": 2, "float32": 4}


class Call(NamedTuple):
    kind: str          # "attention_fwd", "attention_bwd" or "grouping"
    nbytes: float
    flops: float
    dtype: str


def least_seconds(calls: Iterable[Call]) -> float:
    """Sum over the calls of max(bytes / HBM rate, operations / peak)."""
    return sum(max(c.nbytes / HBM_BYTES_PER_S, c.flops / PEAK_FLOPS[c.dtype]) for c in calls)


def attention_fwd(b, lq, lk, heads, dtype, save_p, bias2d=False, biasb=False) -> Call:
    e, d = _ELEMENT[dtype], heads * HEAD_DIM
    nbytes = e * d * (2 * b * lq + 2 * b * lk) + (e * b * heads * lq * lk if save_p else 0)
    nbytes += 4 * (lq * lk * bias2d + b * lk * biasb)
    return Call("attention_fwd", nbytes, 4.0 * b * heads * lq * lk * HEAD_DIM, dtype)


def attention_bwd(b, lq, lk, heads, dtype) -> Call:
    e, d = _ELEMENT[dtype], heads * HEAD_DIM
    nbytes = e * (b * heads * lq * lk + d * (3 * b * lq + 4 * b * lk))
    return Call("attention_bwd", nbytes, 8.0 * b * heads * lq * lk * HEAD_DIM, dtype)


def grouping(n, g, l, d, dtype, training) -> Call:
    e = _ELEMENT[dtype]
    nbytes = e * (2 * n * g * d + 2 * n * l * d) + 4 * n * g * l * (4 if training else 2)
    return Call("grouping", nbytes, 4.0 * n * g * l * d, dtype)


def _vision_attention(s: Sizes, n: int, patches: int) -> List[Tuple[int, int, int]]:
    """(batch, Lq, Lk) of the vision tower's 64-dim-head attention over
    `patches` patch tokens (CLS split off before the first stage)."""
    g = s.group_num
    rows = [(n, patches, patches)] * s.first_stage_layer
    rows += [(n, g, g + patches)] * s.cross_layer
    return rows


def step_calls(s: Sizes, batch: int, dtype: str) -> List[Call]:
    """The attention and grouping calls of one pretraining step: the text
    tower (causal bias), the grouping path, the MAE path; each attention
    forward saves P and has its backward. The MAE decoder's heads are not
    64-dim and take no kernel."""
    kept = s.mae_keep - 1
    second = s.vision_layers - s.first_stage_layer
    g = s.group_num
    rows = [(batch, s.max_words, s.max_words, s.text_heads, True)] * s.transformer_layers
    # the grouping path ends in blocks over the groups, the MAE path in
    # blocks over the kept patches
    for patches, last in ((s.patches, g), (kept, kept)):
        rows += [(n, lq, lk, s.vision_heads, False)
                 for n, lq, lk in _vision_attention(s, batch, patches)]
        rows += [(batch, last, last, s.vision_heads, False)] * second
    calls = []
    for b, lq, lk, h, causal in rows:
        calls.append(attention_fwd(b, lq, lk, h, dtype, True, bias2d=causal))
        calls.append(attention_bwd(b, lq, lk, h, dtype))
    calls += [grouping(batch, g, s.patches, s.vision_width, dtype, True),
              grouping(batch, g, kept, s.vision_width, dtype, True)]
    return calls


def crop_calls(s: Sizes, crops: int, dtype: str) -> List[Call]:
    """The attention and grouping calls of one eval encode of `crops`
    crops at the training resolution (no P saved)."""
    second = s.vision_layers - s.first_stage_layer
    calls = [attention_fwd(n, lq, lk, s.vision_heads, dtype, False)
             for n, lq, lk in _vision_attention(s, crops, s.patches)]
    calls += [attention_fwd(crops, s.group_num, s.group_num, s.vision_heads, dtype, False)] * second
    calls.append(grouping(crops, s.group_num, s.patches, s.vision_width, dtype, False))
    return calls


def _blocks(n: int, tokens: int, width: int, layers: int) -> float:
    """Pre-LN blocks with a 4x MLP: QKV, out and MLP products and the two
    attention products."""
    return layers * (24.0 * n * tokens * width ** 2 + 4.0 * n * tokens ** 2 * width)


def _semantic(n: int, s: Sizes, patches: int) -> float:
    w, g = s.vision_width, s.group_num
    cross = s.cross_layer * (2.0 * n * g * w * w + 4.0 * n * (g + patches) * w * w
                             + 4.0 * n * g * (g + patches) * w + 2.0 * n * g * w * w
                             + 16.0 * n * g * w * w)
    convs = 2 * 2.0 * n * patches * w * (w // s.vision_heads)
    return cross + convs + 4.0 * n * g * patches * w + 16.0 * n * g * w * w


def vision_flops(s: Sizes, n: int) -> float:
    """Forward FLOPs of the vision tower's grouping path over n crops."""
    w, l, g = s.vision_width, s.patches, s.group_num
    second = s.vision_layers - s.first_stage_layer
    return (2.0 * n * l * 3 * s.vision_patch_size ** 2 * w + _blocks(n, l, w, s.first_stage_layer)
            + _semantic(n, s, l) + _blocks(n, g, w, second)
            + 2.0 * n * (1 + g) * w * s.embed_dim)


def step_model_flops(s: Sizes, batch: int) -> float:
    """Model FLOPs of one pretraining step: 3x the forward's products (the
    text tower, the grouping path, the masked MAE path with its decoder,
    the InfoNCE and superpixel products); recompute is not counted."""
    t, w, g, l = s.transformer_width, s.vision_width, s.group_num, s.patches
    kept = s.mae_keep - 1
    second = s.vision_layers - s.first_stage_layer
    dec = w // 2
    text = _blocks(batch, s.max_words, t, s.transformer_layers) + 2.0 * batch * t * s.embed_dim
    mae = (2.0 * batch * l * 3 * s.vision_patch_size ** 2 * w
           + _blocks(batch, kept, w, s.first_stage_layer) + _semantic(batch, s, kept)
           + 2.0 * batch * kept * g * g + 2.0 * batch * kept * g * w
           + _blocks(batch, kept, w, second)
           + 2.0 * batch * (1 + kept) * w * dec
           + _blocks(batch, 1 + l, dec, s.mae_decoder_depth)
           + 2.0 * batch * (1 + l) * dec * 3 * s.vision_patch_size ** 2)
    losses = 4.0 * batch * batch * s.embed_dim + 2.0 * batch * l * l * g
    return 3.0 * (text + vision_flops(s, batch) + mae + losses)
