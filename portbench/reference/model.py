"""SegCLIP (arXiv:2211.14813) in plain PyTorch, float32, written from the
paper and the reference repository's layer equations, on a flat dict of
parameters named as the released state dict (`clip.visual.transformer.
layers0.3.attn.in_proj_weight`, ...).

It imports nothing of the program. Every product goes through
`Precision.mm`, which computes it in float32 with TF32 off, or rounds its
operands first to TF32 or to FP8 (E4M3, scaled per tensor): the lower
precisions are the controls that show the comparison bites.

The parts:
  - CLIP's text tower (causal, EOT pooling) and vision tower (patchify,
    CLS, learned positions, ln_pre), pre-LN blocks with QuickGELU;
  - SegViT: `first_stage_layer` blocks over the patches (CLS split off),
    the Semantic Learner (centres cross-attend [centres; patches], grouped
    1x1 channel mixes give keys and values, logits q.k unscaled, hard
    assignment over the groups, Gumbel straight-through at training,
    count-normalised aggregation, QuickGELU(MLP(LN(q + grouped)))), then
    the remaining blocks over the groups with CLS = max over groups; on the
    MAE path a learned (G, G) mix scatters the groups back to the kept
    patches and the MAE blocks run over them, CLS = their mean;
  - the losses: symmetric InfoNCE with the logit scale capped at 100, the
    superpixel symmetric KL, and the vision MAE (timm-style decoder, fixed
    2D sin-cos positions, pixel MSE over the removed patches).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa, to nearest with ties away."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x scaled so that its largest magnitude is E4M3's 448, rounded to
    E4M3, and scaled back (per-tensor scaling, as FP8 training scales)."""
    x = x.float()
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


_ROUNDERS = {"fp32": None, "tf32": round_tf32, "fp8": round_fp8}


@dataclass(frozen=True)
class Precision:
    """Where the reference's products are rounded: "fp32" (none), "tf32"
    or "fp8" (the operands of every product)."""
    name: str = "fp32"

    def __post_init__(self):
        if self.name not in _ROUNDERS:
            raise ValueError(f"precision must be one of {sorted(_ROUNDERS)}, got {self.name!r}")

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        rnd = _ROUNDERS[self.name]
        if rnd is not None:
            a, b = rnd(a), rnd(b)
        return torch.matmul(a.float(), b.float())


@dataclass(frozen=True)
class Sizes:
    """The sizes the reference reads from a configuration file."""
    image_resolution: int
    vision_patch_size: int
    vision_width: int
    vision_layers: int
    first_stage_layer: int
    group_num: int
    cross_layer: int
    context_length: int
    vocab_size: int
    transformer_width: int
    transformer_layers: int
    embed_dim: int
    mae_vis_mask_ratio: float
    mae_decoder_depth: int
    mae_decoder_num_heads: int
    gumbel_tau: float
    max_words: int

    @classmethod
    def of(cls, cfg: dict) -> "Sizes":
        return cls(**{k: cfg[k] for k in cls.__dataclass_fields__})

    @property
    def grid(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @property
    def patches(self) -> int:
        return self.grid * self.grid

    @property
    def vision_heads(self) -> int:
        return self.vision_width // 64

    @property
    def text_heads(self) -> int:
        return self.transformer_width // 64

    @property
    def mae_keep(self) -> int:
        """Tokens the masked forward keeps, CLS included."""
        return int((self.patches + 1) * (1 - self.mae_vis_mask_ratio))


# ---------------------------------------------------------------- parameters

def _block_specs(prefix: str, width: int) -> List[Tuple[str, tuple, str]]:
    return [
        (f"{prefix}.ln_1.weight", (width,), "one"), (f"{prefix}.ln_1.bias", (width,), "zero"),
        (f"{prefix}.attn.in_proj_weight", (3 * width, width), "trunc"),
        (f"{prefix}.attn.in_proj_bias", (3 * width,), "zero"),
        (f"{prefix}.attn.out_proj.weight", (width, width), "trunc"),
        (f"{prefix}.attn.out_proj.bias", (width,), "zero"),
        (f"{prefix}.ln_2.weight", (width,), "one"), (f"{prefix}.ln_2.bias", (width,), "zero"),
        (f"{prefix}.mlp.c_fc.weight", (4 * width, width), "trunc"),
        (f"{prefix}.mlp.c_fc.bias", (4 * width,), "zero"),
        (f"{prefix}.mlp.c_proj.weight", (width, 4 * width), "trunc"),
        (f"{prefix}.mlp.c_proj.bias", (width,), "zero"),
    ]


def param_specs(s: Sizes) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter, in a fixed order. init is
    "one", "zero", "logit_scale", "trunc" (normal 0.02 clipped at two
    standard deviations), "normal:<std>" or "xavier" (normal with
    Glorot's variance 2 / (fan_in + fan_out))."""
    w, t, e = s.vision_width, s.transformer_width, s.embed_dim
    p, g, dec = s.vision_patch_size, s.group_num, s.vision_width // 2
    specs = [
        ("clip.positional_embedding", (s.context_length, t), "normal:0.01"),
        ("clip.text_projection", (t, e), f"normal:{t ** -0.5}"),
        ("clip.logit_scale", (), "logit_scale"),
        ("clip.visual.class_embedding", (w,), f"normal:{w ** -0.5}"),
        ("clip.visual.positional_embedding", (s.patches + 1, w), f"normal:{w ** -0.5}"),
        ("clip.visual.proj", (w, e), f"normal:{w ** -0.5}"),
        ("clip.visual.conv1.weight", (w, 3, p, p), f"normal:{(3 * p * p) ** -0.5}"),
        ("clip.visual.ln_pre.weight", (w,), "one"), ("clip.visual.ln_pre.bias", (w,), "zero"),
    ]
    vt = "clip.visual.transformer"
    for i in range(s.first_stage_layer):
        specs += _block_specs(f"{vt}.layers0.{i}", w)
    sl = f"{vt}.semantic_layer2"
    specs += [(f"{sl}.semantic_center", (g, w), "trunc"),
              (f"{sl}.norm.weight", (w,), "one"), (f"{sl}.norm.bias", (w,), "zero")]
    for i in range(s.cross_layer):
        c = f"{sl}.cross_att.{i}"
        specs += [(f"{c}.ln_x.weight", (w,), "one"), (f"{c}.ln_x.bias", (w,), "zero"),
                  (f"{c}.ln_k.weight", (w,), "one"), (f"{c}.ln_k.bias", (w,), "zero")]
        specs += [x for x in _block_specs(c, w) if ".ln_1." not in x[0]]
    heads = s.vision_heads
    specs += [
        (f"{sl}.cross_ln.weight", (w,), "one"), (f"{sl}.cross_ln.bias", (w,), "zero"),
        (f"{sl}.k_conv.weight", (w, w // heads, 1), "trunc"),
        (f"{sl}.k_ln.weight", (w,), "one"), (f"{sl}.k_ln.bias", (w,), "zero"),
        (f"{sl}.v_conv.weight", (w, w // heads, 1), "trunc"),
        (f"{sl}.proj_o.ln.weight", (w,), "one"), (f"{sl}.proj_o.ln.bias", (w,), "zero"),
        (f"{sl}.proj_o.mlp.fc1.weight", (4 * w, w), "trunc"),
        (f"{sl}.proj_o.mlp.fc1.bias", (4 * w,), "zero"),
        (f"{sl}.proj_o.mlp.fc2.weight", (w, 4 * w), "trunc"),
        (f"{sl}.proj_o.mlp.fc2.bias", (w,), "zero"),
    ]
    for i in range(s.vision_layers - s.first_stage_layer):
        specs += _block_specs(f"{vt}.layers2.{i}", w)
    for i in range(s.vision_layers - s.first_stage_layer):
        specs += _block_specs(f"{vt}.layers_mae2.{i}", w)
    specs += [(f"{vt}.reconstruct_layer2.rec_proj_a.a_fc.weight", (g, g), "trunc"),
              (f"{vt}.reconstruct_layer2.rec_proj_a.a_fc.bias", (g,), "zero"),
              ("clip.visual.ln_post.weight", (w,), "one"),
              ("clip.visual.ln_post.bias", (w,), "zero")]
    for i in range(s.transformer_layers):
        specs += _block_specs(f"clip.transformer.resblocks.{i}", t)
    specs += [("clip.token_embedding.weight", (s.vocab_size, t), "normal:0.02"),
              ("clip.ln_final.weight", (t,), "one"), ("clip.ln_final.bias", (t,), "zero")]
    m = "vis_mae_decoder"
    specs += [(f"{m}.mask_token", (1, 1, dec), "normal:0.02"),
              (f"{m}.decoder_embed.weight", (dec, w), "xavier"),
              (f"{m}.decoder_embed.bias", (dec,), "zero")]
    for i in range(s.mae_decoder_depth):
        b = f"{m}.decoder_blocks.{i}"
        specs += [(f"{b}.norm1.weight", (dec,), "one"), (f"{b}.norm1.bias", (dec,), "zero"),
                  (f"{b}.attn.qkv.weight", (3 * dec, dec), "xavier"),
                  (f"{b}.attn.qkv.bias", (3 * dec,), "zero"),
                  (f"{b}.attn.proj.weight", (dec, dec), "xavier"),
                  (f"{b}.attn.proj.bias", (dec,), "zero"),
                  (f"{b}.norm2.weight", (dec,), "one"), (f"{b}.norm2.bias", (dec,), "zero"),
                  (f"{b}.mlp.fc1.weight", (4 * dec, dec), "xavier"),
                  (f"{b}.mlp.fc1.bias", (4 * dec,), "zero"),
                  (f"{b}.mlp.fc2.weight", (dec, 4 * dec), "xavier"),
                  (f"{b}.mlp.fc2.bias", (dec,), "zero")]
    specs += [(f"{m}.decoder_norm.weight", (dec,), "one"), (f"{m}.decoder_norm.bias", (dec,), "zero"),
              (f"{m}.decoder_pred.weight", (p * p * 3, dec), "xavier"),
              (f"{m}.decoder_pred.bias", (p * p * 3,), "zero")]
    return specs


def make_params(s: Sizes, seed: int, device) -> Params:
    """Every parameter from `seed`: one standard-normal draw on `device` by
    a generator of its own, cut into the leaves in `param_specs` order and
    scaled per leaf. The same seed gives the same parameters."""
    specs = param_specs(s)
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    params, off = {}, 0
    for name, shape, init in specs:
        n = math.prod(shape)
        z = flat[off:off + n].view(shape)
        off += n
        if init == "one":
            v = torch.ones(shape, device=device)
        elif init == "zero":
            v = torch.zeros(shape, device=device)
        elif init == "logit_scale":
            v = torch.full(shape, math.log(1 / 0.07), device=device)
        elif init == "trunc":
            v = z.clamp(-2.0, 2.0) * 0.02
        elif init == "xavier":
            fan_out, fan_in = shape[0], math.prod(shape[1:])
            v = z * math.sqrt(2.0 / (fan_in + fan_out))
        else:
            v = z * float(init.split(":", 1)[1])
        params[name] = v.clone()
    return params


# ---------------------------------------------------------------- layers

def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def layer_norm(x, P: Params, name: str, eps: float = 1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], eps)


def linear(x, P: Params, name: str, prec: Precision):
    return prec.mm(x, P[f"{name}.weight"].t()) + P[f"{name}.bias"]


def attend(q, k, v, heads: int, prec: Precision, bias=None):
    """softmax(q kᵀ / √d + bias) v per head over (B, L, H·d) operands."""
    b, lq, width = q.shape
    d = width // heads
    qh = q.reshape(b, lq, heads, d).transpose(1, 2)
    kh = k.reshape(b, k.shape[1], heads, d).transpose(1, 2)
    vh = v.reshape(b, v.shape[1], heads, d).transpose(1, 2)
    scores = prec.mm(qh, kh.transpose(-1, -2)) * d ** -0.5
    if bias is not None:
        scores = scores + bias
    out = prec.mm(torch.softmax(scores, dim=-1), vh)
    return out.transpose(1, 2).reshape(b, lq, width)


def packed_attention(P: Params, name: str, x, kv, heads: int, prec: Precision,
                     bias=None, qkv_name="in_proj", out_name="out_proj"):
    """Self- (kv None) or cross-attention with one packed (3d, d) q|k|v
    projection: torch's MultiheadAttention (`in_proj_*`, `out_proj`) or
    timm's (`qkv`, `proj`)."""
    if qkv_name == "in_proj":
        w, bq = P[f"{name}.in_proj_weight"], P[f"{name}.in_proj_bias"]
    else:
        w, bq = P[f"{name}.{qkv_name}.weight"], P[f"{name}.{qkv_name}.bias"]
    d = w.shape[1]
    kv = x if kv is None else kv
    q = prec.mm(x, w[:d].t()) + bq[:d]
    k = prec.mm(kv, w[d:2 * d].t()) + bq[d:2 * d]
    v = prec.mm(kv, w[2 * d:].t()) + bq[2 * d:]
    return linear(attend(q, k, v, heads, prec, bias), P, f"{name}.{out_name}", prec)


def resblock(P: Params, name: str, x, heads: int, prec: Precision, bias=None):
    x = x + packed_attention(P, f"{name}.attn", layer_norm(x, P, f"{name}.ln_1"), None,
                             heads, prec, bias)
    h = quick_gelu(linear(layer_norm(x, P, f"{name}.ln_2"), P, f"{name}.mlp.c_fc", prec))
    return x + linear(h, P, f"{name}.mlp.c_proj", prec)


def grouped_linear(x, weight, groups: int, prec: Precision):
    """The grouped 1x1 Conv1d over channels: weight (groups·o, i, 1)."""
    b, l, d = x.shape
    w = weight.reshape(groups, d // groups, d // groups)           # (g, o, i)
    xg = x.reshape(b, l, groups, d // groups).transpose(1, 2)       # (b, g, l, i)
    out = prec.mm(xg, w.transpose(1, 2)[None])                      # (b, g, l, o)
    return out.transpose(1, 2).reshape(b, l, d)


# ---------------------------------------------------------------- towers

def encode_text(P: Params, s: Sizes, ids: torch.Tensor, prec: Precision) -> torch.Tensor:
    """ids (B, L) → the EOT-pooled projected feature (B, E)."""
    length = ids.shape[1]
    x = P["clip.token_embedding.weight"][ids] + P["clip.positional_embedding"][:length]
    causal = torch.full((length, length), float("-inf"), device=ids.device).triu(1)
    for i in range(s.transformer_layers):
        x = resblock(P, f"clip.transformer.resblocks.{i}", x, s.text_heads, prec, causal)
    x = layer_norm(x, P, "clip.ln_final")
    pooled = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
    return prec.mm(pooled, P["clip.text_projection"])


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel(0, 1) from uniform draws u in [0, 1)."""
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def semantic_learner(P: Params, s: Sizes, x, prec: Precision, noise=None):
    """x (B, L, W) patch features → (groups (B, G, W), hard (B, G, L),
    soft (B, G, L)). With Gumbel noise (B, G, L) the hard assignment is the
    one-hot argmax of softmax((logits + noise) / tau) over the groups, with
    that softmax's gradient (straight-through)."""
    sl = "clip.visual.transformer.semantic_layer2"
    heads = s.vision_heads
    feats = layer_norm(x, P, f"{sl}.norm")
    q = P[f"{sl}.semantic_center"][None].expand(x.shape[0], -1, -1)
    for i in range(s.cross_layer):
        c = f"{sl}.cross_att.{i}"
        kv = torch.cat([q, x], dim=1)
        q = q + packed_attention(P, f"{c}.attn", layer_norm(q, P, f"{c}.ln_x"),
                                 layer_norm(kv, P, f"{c}.ln_k"), heads, prec)
        h = quick_gelu(linear(layer_norm(q, P, f"{c}.ln_2"), P, f"{c}.mlp.c_fc", prec))
        q = q + linear(h, P, f"{c}.mlp.c_proj", prec)
    q = layer_norm(q, P, f"{sl}.cross_ln")
    k = layer_norm(grouped_linear(feats, P[f"{sl}.k_conv.weight"], heads, prec), P, f"{sl}.k_ln")
    v = grouped_linear(feats, P[f"{sl}.v_conv.weight"], heads, prec)
    logits = prec.mm(q, k.transpose(1, 2))                           # (B, G, L)
    soft = torch.softmax(logits, dim=1)
    y = soft if noise is None else torch.softmax((logits + noise) / s.gumbel_tau, dim=1)
    one_hot = F.one_hot(y.argmax(dim=1), s.group_num).transpose(1, 2).float()
    hard = one_hot + (y - y.detach()) if noise is not None else one_hot
    counts = hard.sum(dim=-1, keepdim=True)
    grouped = prec.mm(hard, v) / torch.maximum(counts, torch.ones_like(counts))
    z = linear(layer_norm(q + grouped, P, f"{sl}.proj_o.ln"), P, f"{sl}.proj_o.mlp.fc1", prec)
    out = quick_gelu(linear(F.gelu(z), P, f"{sl}.proj_o.mlp.fc2", prec))
    return out, hard, soft


def patch_tokens(P: Params, s: Sizes, image, prec: Precision):
    """image (B, H, W, 3) normalised → ln_pre(CLS + patches + positions)."""
    b, h, w, c = image.shape
    p = s.vision_patch_size
    gh, gw = h // p, w // p
    if (gh, gw) != (s.grid, s.grid):
        raise ValueError(f"the reference takes {s.image_resolution}-pixel crops, got {h}x{w}")
    x = image[:, :gh * p, :gw * p].reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4)
    x = prec.mm(x.reshape(b, gh * gw, c * p * p),
                P["clip.visual.conv1.weight"].reshape(s.vision_width, -1).t())
    cls = P["clip.visual.class_embedding"][None, None].expand(b, 1, -1)
    x = torch.cat([cls, x], dim=1) + P["clip.visual.positional_embedding"]
    return layer_norm(x, P, "clip.visual.ln_pre")


def blocks(P: Params, prefix: str, n: int, x, heads: int, prec: Precision):
    for i in range(n):
        x = resblock(P, f"{prefix}.{i}", x, heads, prec)
    return x


def encode_image(P: Params, s: Sizes, image, prec: Precision, noise=None):
    """The grouping path: (pooled (B, E), group features (B, G, E), soft
    attention (B, G, L), hard attention (B, G, L))."""
    vt = "clip.visual.transformer"
    x = patch_tokens(P, s, image, prec)
    x = blocks(P, f"{vt}.layers0", s.first_stage_layer, x[:, 1:], s.vision_heads, prec)
    gx, hard, soft = semantic_learner(P, s, x, prec, noise)
    gx = blocks(P, f"{vt}.layers2", s.vision_layers - s.first_stage_layer, gx,
                s.vision_heads, prec)
    tokens = torch.cat([gx.amax(dim=1, keepdim=True), gx], dim=1)
    hidden = prec.mm(layer_norm(tokens, P, "clip.visual.ln_post"), P["clip.visual.proj"])
    return hidden[:, 0], hidden[:, 1:], soft, hard


def mask_order(u: torch.Tensor, keep: int):
    """MAE masking from uniform draws u (B, 1+L): CLS pinned first, the
    `keep` lowest draws kept. Returns (ids_keep (B, keep), ids_restore
    (B, 1+L), mask (B, 1+L) with 1 where removed)."""
    u = u.clone()
    u[:, 0] = -1.0
    shuffle = torch.argsort(u, dim=1, stable=True)
    restore = torch.argsort(shuffle, dim=1, stable=True)
    mask = torch.ones_like(u)
    mask[:, :keep] = 0
    return shuffle[:, :keep], restore, torch.gather(mask, 1, restore)


def sincos_2d(dim: int, grid: int) -> np.ndarray:
    """MAE's fixed 2D sin-cos table with a zero CLS row, (1 + grid², dim)."""
    def one_d(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.outer(pos.astype(np.float64), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)
    gw, gh = np.meshgrid(np.arange(grid, dtype=np.float32), np.arange(grid, dtype=np.float32))
    emb = np.concatenate([one_d(dim // 2, gw.reshape(-1)), one_d(dim // 2, gh.reshape(-1))], 1)
    return np.concatenate([np.zeros((1, dim)), emb], 0).astype(np.float32)


def mae_loss_sum(P: Params, s: Sizes, image, prec: Precision, mask_u, noise_mae):
    """The masked forward and the MAE decoder: (sum over the removed
    patches of the per-patch pixel MSE, number of removed patches)."""
    vt, m = "clip.visual.transformer", "vis_mae_decoder"
    keep = s.mae_keep
    ids_keep, restore, mask = mask_order(mask_u, keep)
    x = patch_tokens(P, s, image, prec)
    x = torch.gather(x, 1, ids_keep[:, :, None].expand(-1, -1, x.shape[-1]))
    x = blocks(P, f"{vt}.layers0", s.first_stage_layer, x[:, 1:], s.vision_heads, prec)
    sx, hard, _ = semantic_learner(P, s, x, prec, noise_mae)
    a = linear(hard.transpose(1, 2), P, f"{vt}.reconstruct_layer2.rec_proj_a.a_fc", prec)
    x = quick_gelu(prec.mm(a, sx))
    x = blocks(P, f"{vt}.layers_mae2", s.vision_layers - s.first_stage_layer, x,
               s.vision_heads, prec)
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
    x = linear(x, P, f"{m}.decoder_embed", prec)
    b, kept, d = x.shape
    x = torch.cat([x, P[f"{m}.mask_token"].expand(b, restore.shape[1] - kept, d)], dim=1)
    x = torch.gather(x, 1, restore[:, :, None].expand(-1, -1, d))
    x = x + torch.from_numpy(sincos_2d(d, s.grid)).to(x.device)
    heads = s.mae_decoder_num_heads
    for i in range(s.mae_decoder_depth):
        bn = f"{m}.decoder_blocks.{i}"
        x = x + packed_attention(P, f"{bn}.attn", layer_norm(x, P, f"{bn}.norm1", 1e-6), None,
                                 heads, prec, qkv_name="qkv", out_name="proj")
        h = F.gelu(linear(layer_norm(x, P, f"{bn}.norm2", 1e-6), P, f"{bn}.mlp.fc1", prec))
        x = x + linear(h, P, f"{bn}.mlp.fc2", prec)
    pred = linear(layer_norm(x, P, f"{m}.decoder_norm", 1e-6), P, f"{m}.decoder_pred", prec)
    p, g = s.vision_patch_size, s.grid
    target = image.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, -1)
    per_patch = (pred[:, 1:] - target).square().mean(dim=-1)
    removed = mask[:, 1:]
    return (per_patch * removed).sum(), removed.sum()


# ---------------------------------------------------------------- losses

def info_nce(text: torch.Tensor, vision: torch.Tensor, logit_scale: torch.Tensor,
             prec: Precision) -> torch.Tensor:
    """Symmetric InfoNCE over the batch, scale min(exp(logit_scale), 100)."""
    t = text / text.norm(dim=-1, keepdim=True)
    v = vision / vision.norm(dim=-1, keepdim=True)
    scale = torch.clamp(logit_scale.exp(), max=100.0)
    logits = scale * prec.mm(t, v.t())
    labels = torch.arange(t.shape[0], device=t.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels)) / 2


def superpixel_kl_sum(hard: torch.Tensor, seg: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Sum over the rows of KL(softmax(a) ‖ softmax(m)) + KL(softmax(m) ‖
    softmax(a)), a the per-patch hard assignment (as logits over the
    groups) and m its mean over the patch's superpixel; halved. The loss is
    this over B·L·G of the whole batch."""
    a = hard.transpose(1, 2)                                     # (B, L, G)
    seg = seg.reshape(seg.shape[0], -1)
    same = (seg[:, :, None] == seg[:, None, :]).float()
    mean = prec.mm(same, a) / same.sum(dim=-1, keepdim=True).clamp(min=1)

    def kl(p_logits, q_logits):
        return F.kl_div(torch.log_softmax(p_logits, dim=-1), torch.log_softmax(q_logits, dim=-1),
                        reduction="sum", log_target=True)

    return (kl(a, mean) + kl(mean, a)) / 2
