"""One SegCLIP pretraining step in plain PyTorch (float32), as the reference
repository's main_task_align.py takes it: the three losses, the backward,
the global-norm clip at `max_grad_norm`, the NaN skip, AdamW with the
schedule and the weight decay applied before the update
(modules/optimization_adamw.py), and the clamp of logit_scale at ln 100.

The gradient of the whole batch is taken in blocks of rows so that it fits
beside nothing else on the card: the pooled features of every row first,
without gradients, then the InfoNCE's gradient with respect to them, then
each block's forward again with its share of every loss and the features'
gradient, backward. The sum is the whole batch's gradient.

Which parameters train, and at which rate, follows the reference's freeze
passes and parameter groups: the stock ViT's patchify, position and class
embeddings, ln_pre and the text token and position embeddings are frozen;
the pretrained towers' blocks, ln_final, text_projection and logit_scale
take `lower_lr`; the new parts (Semantic Learner, the group and MAE
blocks, the reconstruction, ln_post, proj) and the MAE decoder `lr`; no
weight decay on biases.

The Gumbel and masking draws are made the way the SegCLIP port documents
its step's stream (segclip_tpu_torch/train/step.py: a generator seeded by
(seed << 32) | step on the batch's device, the grouping path's uniform
draws (B, G, L), then the masking's (B, 1 + L), then the MAE path's
(B, G, kept patches)): they are the step's input, given to both sides.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from portbench.reference.model import (Params, Precision, Sizes, encode_image, encode_text,
                                       gumbel, info_nce, mae_loss_sum, superpixel_kl_sum)

LOGIT_SCALE_MAX = math.log(100.0)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

_FROZEN = ("clip.visual.class_embedding", "clip.visual.positional_embedding",
           "clip.visual.conv1.", "clip.visual.ln_pre.", "clip.token_embedding.",
           "clip.positional_embedding")
_LOWER = ("clip.visual.transformer.layers0.", "clip.transformer.resblocks.", "clip.ln_final.",
          "clip.text_projection", "clip.logit_scale")


def trainable(name: str) -> bool:
    return not name.startswith(_FROZEN)


def peak_lr(name: str, optim: dict) -> float:
    return optim["lower_lr"] if name.startswith(_LOWER) else optim["lr"]


def weight_decay(name: str, optim: dict) -> float:
    return 0.0 if "bias" in name.rsplit(".", 1)[-1] else optim["weight_decay"]


def schedule(step: int, optim: dict, t_total: int) -> float:
    """warmup_cosine at x = step / t_total: linear warm-up over
    `warmup_proportion`, then half a cosine to 0."""
    x, warm = step / t_total, optim["warmup_proportion"]
    if x < warm:
        return x / warm
    return 0.5 * (1.0 + math.cos(math.pi * (x - warm) / (1.0 - warm)))


def normalize(image_u8: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(CLIP_MEAN, device=image_u8.device)
    std = torch.tensor(CLIP_STD, device=image_u8.device)
    return (image_u8.float() / 255.0 - mean) / std


def step_draws(device, seed: int, step: int, s: Sizes, batch: int) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed((seed << 32) | step)
    g, l = s.group_num, s.patches
    return {"gumbel": gumbel(torch.rand((batch, g, l), generator=gen, device=device)),
            "mask": torch.rand((batch, l + 1), generator=gen, device=device),
            "gumbel_mae": gumbel(torch.rand((batch, g, s.mae_keep - 1), generator=gen,
                                            device=device))}


@dataclass
class RefState:
    """Parameters (float32 leaves), AdamW's moments and step count."""
    params: Params
    exp_avg: Dict[str, torch.Tensor] = field(default_factory=dict)
    exp_avg_sq: Dict[str, torch.Tensor] = field(default_factory=dict)
    count: int = 0


def _features(P, s, batch, draws, rows, prec):
    image = normalize(batch["image"][rows])
    t = encode_text(P, s, batch["input_ids"][rows], prec)
    v, _, _, hard = encode_image(P, s, image, prec, draws["gumbel"][rows])
    return image, t, v, hard


def losses_and_grads(state: RefState, s: Sizes, batch: Dict[str, torch.Tensor],
                     draws: Dict[str, torch.Tensor], prec: Precision,
                     block: int) -> Dict[str, float]:
    """The loss dict of the whole batch; the trainable leaves' `.grad` hold
    its gradient."""
    P = state.params
    b = batch["image"].shape[0]
    spans = [slice(i, min(i + block, b)) for i in range(0, b, block)]
    with torch.no_grad():
        feats = [_features(P, s, batch, draws, r, prec)[1:3] for r in spans]
    t_all = torch.cat([f[0] for f in feats]).requires_grad_()
    v_all = torch.cat([f[1] for f in feats]).requires_grad_()
    del feats
    sim = info_nce(t_all, v_all, P["clip.logit_scale"], prec)
    sim.backward()
    coef = b * s.patches * s.group_num
    removed_total = b * (s.patches + 1 - s.mae_keep)
    seg_sum = mae_sum = 0.0
    for r in spans:
        image, t, v, hard = _features(P, s, batch, draws, r, prec)
        seg = superpixel_kl_sum(hard, batch["image_seg"][r], prec) / coef
        mae, removed = mae_loss_sum(P, s, image, prec, draws["mask"][r], draws["gumbel_mae"][r])
        if int(removed) != removed_total * (r.stop - r.start) // b:
            raise AssertionError("the masking removed another number of patches")
        mae = mae / removed_total
        ((t * t_all.grad[r]).sum() + (v * v_all.grad[r]).sum() + seg + mae).backward()
        seg_sum += float(seg.detach())
        mae_sum += float(mae.detach())
    out = {"sim_loss": float(sim.detach()), "seglabel_loss": seg_sum, "vis_mae_loss": mae_sum}
    out["loss"] = out["sim_loss"] + seg_sum + mae_sum
    return out


def train_step(state: RefState, s: Sizes, batch, draws, optim: dict, t_total: int,
               prec: Precision, block: int = 32) -> Dict[str, object]:
    """One step in place. Returns the losses, the global gradient norm and
    each trainable leaf's gradient after the clip (what AdamW receives)."""
    names = [n for n in state.params if trainable(n)]
    for n in names:
        state.params[n].requires_grad_(True)
        state.params[n].grad = None
    losses = losses_and_grads(state, s, batch, draws, prec, block)
    grads = {n: (state.params[n].grad if state.params[n].grad is not None
                 else torch.zeros_like(state.params[n])) for n in names}
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = torch.clamp(optim["max_grad_norm"] / (norm + 1e-6), max=1.0)
    grads = {n: g * scale for n, g in grads.items()}
    skipped = math.isnan(losses["loss"])
    if not skipped:
        state.count += 1
        k = state.count
        b1, b2, eps = optim["b1"], optim["b2"], optim["eps"]
        factor = schedule(k, optim, t_total)
        with torch.no_grad():
            for n in names:
                p, g = state.params[n], grads[n]
                m = state.exp_avg.get(n, torch.zeros_like(p)) * b1 + g * (1 - b1)
                v = state.exp_avg_sq.get(n, torch.zeros_like(p)) * b2 + g * g * (1 - b2)
                state.exp_avg[n], state.exp_avg_sq[n] = m, v
                lr = peak_lr(n, optim) * factor
                denom = v.sqrt() / math.sqrt(1 - b2 ** k) + eps
                p.add_(-p * lr * weight_decay(n, optim) - (lr / (1 - b1 ** k)) * m / denom)
            ls = state.params["clip.logit_scale"]
            ls.clamp_(max=LOGIT_SCALE_MAX)
    for n in names:
        state.params[n].grad = None
        state.params[n].requires_grad_(False)
    return {"losses": losses, "grad_norm": float(norm), "grads": grads, "skipped": skipped}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.float().norm()) for n, t in tensors.items()}


def run_steps(params: Params, s: Sizes, batches: List[Dict[str, torch.Tensor]], seed: int,
              optim: dict, t_total: int, prec: Precision, block: int = 32) -> dict:
    """The first len(batches) steps from `params` (taken over, changed in
    place). Returns each step's losses, the first step's clipped gradient
    norm per trainable leaf and each leaf's change after the last step."""
    start = {n: params[n].clone() for n in params if trainable(n)}
    state = RefState(params)
    losses, grad_norms = [], None
    for i, batch in enumerate(batches):
        out = train_step(state, s, batch, step_draws(batch["image"].device, seed, i, s,
                                                     batch["image"].shape[0]),
                         optim, t_total, prec, block)
        losses.append(out["losses"]["loss"])
        if i == 0:
            grad_norms = leaf_norms(out["grads"])
        del out
    change = leaf_norms({n: params[n] - start[n] for n in start})
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
