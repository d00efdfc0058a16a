"""SegCLIP: the model that owns the CLIP towers and the MAE decoders and
computes the pretraining losses (segclip_tpu/models/segclip.py), and its
seeded random init.

`SegCLIP.forward` returns the loss dict of the JAX `SegCLIP.__call__`:
  1. global-batch InfoNCE over the pooled features (`info_nce_pair`, with
     the opt-in class mask);
  2. the superpixel symmetric KL on the patch→group hard assignment;
  3. the optional group-usage balance term;
  4. text MAE: a second, masked text forward → vocab CE (training only);
  5. vision MAE: a second, masked image forward → pixel MSE (training only).
The random draws (two Gumbel noises, two masking noises) come from a
torch.Generator, or are injected through `noise` (tests hand both
frameworks the same numbers). The state dict is the reference's layout:
`clip.*`, `vis_mae_decoder.*`, `seq_mae_decoder.*`. `ModelConfig.remat`
puts the towers' and the decoders' block stacks under activation
checkpointing while gradients are recorded (models/layers.run_blocks), as
the JAX model puts them under `nn.remat` (segclip.py:134-148).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from segclip_tpu_torch.config import ModelConfig
from segclip_tpu_torch.models.clip import CLIPModule
from segclip_tpu_torch.models.layers import LayerNormFP32
from segclip_tpu_torch.models.mae_decoder import TextMAEDecoder, VisionMAEDecoder
from segclip_tpu_torch.parallel.collectives import global_gather, rank_of

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# scene_classes is an int32 bitmask: class c > 0 is bit c − 1.
MAX_MASK_CLASS = 31
# The keys of `noise` that SegCLIP.forward takes: the grouping path's and
# the MAE path's Gumbel noise (B, G, L) and (B, G, L_kept), and the masking
# noise of the vision (B, 1+L) and text (B, L) MAE forwards.
NOISE_KEYS = ("gumbel", "gumbel_mae", "mask_vis", "mask_txt")
# The attention routes the JAX package's ModelConfig.attention_impl names
# (segclip_tpu/ops/attention.py:63-66, 102-103). The port accepts the same
# values and, like grouping_impl, routes by the tensors' device instead: its
# kernels on CUDA tensors, their plain versions on the CPU.
ATTENTION_IMPLS = ("xla", "pallas_vmem")
KERNEL_FIELDS = ("attention_impl", "grouping_impl")


def check_attention_impl(cfg: ModelConfig) -> None:
    """Raise, with the JAX package's message, for an attention_impl it
    refuses."""
    if cfg.attention_impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"attention impl {cfg.attention_impl!r} removed — XLA wins at SegCLIP's "
            f"sequence lengths (docs/PERF.md, 'Attention kernel selection')")


def check_kernel_fields(cfg: ModelConfig, log_fn) -> None:
    """What an entry point does with KERNEL_FIELDS: raise for an
    attention_impl the JAX package refuses, and log one line for each field
    set away from its default, since the route does not follow it. Also one
    line for a param_dtype other than "float32": the JAX package accepts the
    field and never reads it (its parameters are float32 whatever it says),
    and neither does the port."""
    check_attention_impl(cfg)
    default = ModelConfig()
    for name in KERNEL_FIELDS:
        value = getattr(cfg, name)
        if value != getattr(default, name):
            log_fn(f"model.{name}={value} is ignored: the port launches its kernels on "
                   f"CUDA tensors and their plain versions on the CPU, whatever the "
                   f"field says")
    if cfg.param_dtype != "float32":
        log_fn(f"model.param_dtype={cfg.param_dtype} is ignored: parameters are stored in "
               f"float32, as the JAX package stores them whatever the field says")


def info_nce_pair(text_feat: torch.Tensor, vis_feat: torch.Tensor,
                  logit_scale: torch.Tensor,
                  text_class: Optional[torch.Tensor] = None,
                  scene_classes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric global-batch InfoNCE. With text_class / scene_classes
    (infonce_mask="class"; (B,) ints, text_class 0 = unstructured), entries
    whose caption truthfully names a class present in the image are masked
    out of the softmax denominator, except the labelled positive."""
    t = text_feat / torch.linalg.vector_norm(text_feat, dim=-1, keepdim=True)
    v = vis_feat / torch.linalg.vector_norm(vis_feat, dim=-1, keepdim=True)
    scale = torch.minimum(logit_scale.float().exp(),
                          torch.tensor(100.0, device=logit_scale.device))
    v_all, t_all = global_gather(v), global_gather(t)
    logits_t2v = scale * (t.float() @ v_all.float().T)
    logits_v2t = scale * (v.float() @ t_all.float().T)
    local_b = t.shape[0]
    labels = torch.arange(local_b, device=t.device) + local_b * rank_of()

    if text_class is not None:
        if scene_classes is None:
            raise ValueError("the class mask needs scene_classes beside text_class")
        tc, sc = text_class.long(), scene_classes.long()
        tc_all, sc_all = global_gather(tc), global_gather(sc)
        cols = torch.arange(tc_all.shape[0], device=t.device)
        not_self = cols[None, :] != labels[:, None]

        def truthful(named, scene_bits):
            bit = torch.clamp(named - 1, min=0)
            return (named > 0) & (((scene_bits >> bit) & 1) == 1)

        fn_t2v = truthful(tc[:, None], sc_all[None, :]) & not_self
        fn_v2t = truthful(tc_all[None, :], sc[:, None]) & not_self
        logits_t2v = logits_t2v.masked_fill(fn_t2v, -1e9)
        logits_v2t = logits_v2t.masked_fill(fn_v2t, -1e9)

    def ce(logits):
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, 1, labels[:, None]).mean()

    return (ce(logits_t2v) + ce(logits_v2t)) / 2.0


def check_class_mask_inputs(text_class: Optional[torch.Tensor],
                            scene_classes: Optional[torch.Tensor]) -> None:
    """The class mask needs both tensors, and every class must fit the
    int32 bitmask (classes 1..31). Reads the values on the host."""
    if text_class is None or scene_classes is None:
        raise ValueError(
            "model.infonce_mask='class' needs text_class and scene_classes in "
            "the batch — corpus missing the <name>_meta.sgr sidecar?")
    top = int(text_class.max())
    if top > MAX_MASK_CLASS or int(text_class.min()) < 0:
        raise ValueError(f"text_class must lie in [0, {MAX_MASK_CLASS}] (an int32 "
                         f"bitmask holds {MAX_MASK_CLASS} classes), got max {top}")
    if int(scene_classes.min()) < 0 or int(scene_classes.max()) >= 2 ** MAX_MASK_CLASS:
        raise ValueError(f"scene_classes must be bitmasks of classes 1..{MAX_MASK_CLASS}")


def superpixel_kl_loss(hard_attn: torch.Tensor, image_seg: torch.Tensor) -> torch.Tensor:
    """Symmetric KL between the per-patch group assignment (B, G, L) and its
    mean over same-superpixel patches; image_seg (B, gh, gw) integer ids."""
    attn = hard_attn.transpose(1, 2).float()                  # (B, L, G)
    b, l, g = attn.shape
    seg = image_seg.reshape(b, -1)
    affinity = (seg[:, :, None] == seg[:, None, :]).float()
    cluster_sum = torch.matmul(affinity, attn)
    counts = affinity.sum(dim=-1, keepdim=True)
    cluster_mean = cluster_sum / torch.maximum(counts, torch.ones_like(counts))
    coef = b * l * g

    def kl(p_logits, q_logits):
        # F.kl_div(log_softmax(p), softmax(q), 'sum'), 0·log 0 := 0
        logp = torch.log_softmax(p_logits, dim=-1)
        q = torch.softmax(q_logits, dim=-1)
        logq = torch.log_softmax(q_logits, dim=-1)
        return (q * (logq - logp)).sum() / coef

    return (kl(attn, cluster_mean) + kl(cluster_mean, attn)) / 2.0


def group_balance_loss(hard_attn: torch.Tensor, weight: float) -> torch.Tensor:
    """weight · KL(mean hard assignment ‖ uniform over groups)."""
    usage = hard_attn.float().mean(dim=(0, 2))                # (G,)
    g = usage.shape[0]
    floor = torch.full_like(usage, 1e-8)
    return weight * (usage * torch.log(torch.maximum(usage * g, floor))).sum()


class SegCLIP(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(DTYPES)}, "
                             f"got {cfg.compute_dtype!r}")
        check_attention_impl(cfg)
        self.cfg = cfg
        dtype = DTYPES[cfg.compute_dtype]
        self.clip = CLIPModule(
            embed_dim=cfg.embed_dim, image_resolution=cfg.image_resolution,
            vision_layers=cfg.vision_layers, vision_width=cfg.vision_width,
            vision_patch_size=cfg.vision_patch_size,
            context_length=cfg.context_length, vocab_size=cfg.vocab_size,
            transformer_width=cfg.transformer_width,
            transformer_layers=cfg.transformer_layers,
            first_stage_layer=cfg.first_stage_layer, group_num=cfg.group_num,
            cross_layer=cfg.cross_layer, tau=cfg.gumbel_tau, compute_dtype=dtype,
            remat=cfg.remat)
        if cfg.use_vision_mae_recon:
            self.vis_mae_decoder = VisionMAEDecoder(
                cfg.vision_width, cfg.vision_width // 2, cfg.image_resolution,
                cfg.vision_patch_size, depth=cfg.mae_decoder_depth,
                heads=cfg.mae_decoder_num_heads, compute_dtype=dtype, remat=cfg.remat)
        if cfg.use_text_mae_recon:
            self.seq_mae_decoder = TextMAEDecoder(
                cfg.embed_dim, cfg.embed_dim // 2, cfg.max_words, cfg.vocab_size,
                depth=cfg.mae_decoder_depth, heads=cfg.mae_decoder_num_heads,
                compute_dtype=dtype, remat=cfg.remat)

    def encode_image(self, image: torch.Tensor, **kw):
        return self.clip.encode_image(image, **kw)

    def encode_text(self, text: torch.Tensor, **kw):
        return self.clip.encode_text(text, **kw)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                image: torch.Tensor, image_seg: Optional[torch.Tensor] = None,
                training: bool = True,
                text_class: Optional[torch.Tensor] = None,
                scene_classes: Optional[torch.Tensor] = None,
                noise: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The loss dict, with "loss" their sum. `noise` may give any of
        NOISE_KEYS; the rest is drawn from `generator` on the inputs'
        device. At training=False only the deterministic losses (InfoNCE,
        superpixel KL) are computed."""
        c = self.cfg
        noise = dict(noise or {})
        unknown = set(noise) - set(NOISE_KEYS)
        if unknown:
            raise KeyError(f"unknown noise keys {sorted(unknown)}; take {NOISE_KEYS}")
        if c.infonce_mask not in ("none", "class"):
            raise ValueError(f"model.infonce_mask must be none|class, "
                             f"got {c.infonce_mask!r}")
        use_mask = c.infonce_mask == "class" and training
        if use_mask:
            check_class_mask_inputs(text_class, scene_classes)

        txt = self.clip.encode_text(input_ids)
        vis = self.clip.encode_image(image, training=training,
                                     gumbel_noise=noise.get("gumbel"),
                                     generator=generator)
        losses = {"sim_loss": info_nce_pair(
            txt.pooled, vis.pooled, self.clip.logit_scale,
            text_class=text_class if use_mask else None,
            scene_classes=scene_classes if use_mask else None)}
        if c.use_seglabel and image_seg is not None:
            losses["seglabel_loss"] = superpixel_kl_loss(vis.mid["hard_attn"], image_seg)
        if c.group_balance_weight > 0 and training:
            losses["group_balance_loss"] = group_balance_loss(
                vis.mid["hard_attn"], c.group_balance_weight)

        if c.use_text_mae_recon and training:
            t_masked = self.clip.encode_text(
                input_ids, mask_ratio=c.mae_seq_mask_ratio,
                mask_noise=noise.get("mask_txt"), generator=generator)
            recon_mask = (t_masked.mae_mask
                          + attention_mask.to(t_masked.mae_mask.dtype)) > 1
            losses["text_mae_loss"] = self.seq_mae_decoder(
                input_ids, t_masked.hidden, recon_mask, t_masked.ids_restore,
                attention_mask)
        if c.use_vision_mae_recon and training:
            v_masked = self.clip.encode_image(
                image, mask_ratio=c.mae_vis_mask_ratio, training=True,
                mask_noise=noise.get("mask_vis"),
                gumbel_noise=noise.get("gumbel_mae"), generator=generator)
            hidden = v_masked.mid["hidden"]
            hidden = torch.cat([hidden.mean(dim=1, keepdim=True), hidden], dim=1)
            losses["vis_mae_loss"] = self.vis_mae_decoder(
                image, hidden, v_masked.mae_mask, v_masked.ids_restore)

        total = 0
        for value in losses.values():
            total = total + value
        losses["loss"] = total
        return losses


def _init_param(name: str, p: torch.Tensor, is_norm: bool,
                gen: torch.Generator) -> None:
    """The JAX package's initialisers, by parameter name: LayerNorm ones and
    zeros, zero biases, truncated normal(0.02) for new linear weights,
    CLIP's scaled normals for the embeddings and projections, and in the
    MAE decoders xavier-uniform weights and a normal(0.02) mask token."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "logit_scale":
        p.fill_(math.log(1 / 0.07))
    elif is_norm:
        p.fill_(1.0 if leaf == "weight" else 0.0)
    elif leaf.endswith("bias"):
        p.zero_()
    elif name.endswith("mask_token"):
        p.normal_(0.0, 0.02, generator=gen)
    elif name.startswith(("vis_mae_decoder.", "seq_mae_decoder.")):
        nn.init.xavier_uniform_(p, generator=gen)
    elif name.endswith("visual.conv1.weight"):
        p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)       # fan-in
    elif name.endswith(("visual.class_embedding",
                        "visual.positional_embedding")):
        p.normal_(0.0, p.shape[-1] ** -0.5, generator=gen)
    elif name.endswith(("visual.proj", "text_projection")):
        p.normal_(0.0, p.shape[0] ** -0.5, generator=gen)
    elif name.endswith("token_embedding.weight"):
        p.normal_(0.0, 0.02, generator=gen)
    elif name == "clip.positional_embedding":
        p.normal_(0.0, 0.01, generator=gen)
    else:
        nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=gen)


def init_segclip(cfg: ModelConfig, seed: int = 0,
                 device: torch.device | str = "cpu") -> SegCLIP:
    """A SegCLIP with random weights from `seed`, drawn on the CPU (so a seed
    gives the same weights on every device), then moved to `device`."""
    model = SegCLIP(cfg)
    gen = torch.Generator().manual_seed(seed)
    norms = {f"{m_name}.{p_name}"
             for m_name, m in model.named_modules()
             if isinstance(m, LayerNormFP32) for p_name, _ in m.named_parameters()}
    with torch.no_grad():
        for name, p in model.named_parameters():
            _init_param(name, p, name in norms, gen)
    return model.to(device).eval()
