"""From-scratch learning regression of the port: the port's counterpart of
tests/test_learning.py. The full 3-loss system (InfoNCE + superpixel-KL +
vision MAE) must drive the contrastive loss well below chance on the
procedural shapes corpus within a fixed step budget.

The same generator, superpixels, tokenizer and tiny 64² tower as the JAX
test, B = 16, 100 steps of the port's make_train_step, every input made from
numpy seed 0. Chance for the symmetric InfoNCE at batch B is ln B; a
collapsed tower pins sim_loss at ln B, so the bar below (0.8·ln B over the
mean of the last three readings) is a tripwire. It runs on the CPU, and on
the card (marker `gpu`, where the kernels take the attention and grouping):

    python -m pytest tests/test_torch_learning.py -q -s -m slow
"""
import numpy as np
import pytest
import torch

from segclip_tpu_torch.config import Config, ModelConfig, OptimConfig
from segclip_tpu_torch.data.procgen import generate_scene
from segclip_tpu_torch.data.superpixel import crop_seg_from_cache, felzenszwalb
from segclip_tpu_torch.data.tokenizer import default_tokenizer, tokenize_with_mask
from segclip_tpu_torch.data.transforms import clip_normalize

pytestmark = pytest.mark.slow

RES, PATCH, B, STEPS = 64, 8, 16, 100


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_full_system_learns_contrastive_alignment(device):
    from segclip_tpu_torch.models.segclip import init_segclip
    from segclip_tpu_torch.parallel.prefetch import to_device
    from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step
    from segclip_tpu_torch.utils.device import resolve_device

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = resolve_device(device)
    tiny = ModelConfig(
        image_resolution=RES, vision_patch_size=PATCH, vision_width=128,
        vision_layers=4, first_stage_layer=3, group_num=4, cross_layer=1,
        context_length=32, vocab_size=49408, transformer_width=128,
        transformer_layers=2, embed_dim=64, max_words=16,
        use_vision_mae_recon=True, use_seglabel=True, mae_decoder_depth=1,
        mae_decoder_num_heads=2, compute_dtype="float32")
    cfg = Config(model=tiny, optim=OptimConfig(lr=3e-4, lower_lr=3e-4,
                                               warmup_proportion=0.1))

    tok = default_tokenizer()
    rng = np.random.default_rng(0)
    n = 128
    samples = []
    for _ in range(n):
        img, _, cap = generate_scene(rng, (RES, RES))
        sp = felzenszwalb(img, scale=64.0, sigma=0.8, min_size=40)
        seg = crop_seg_from_cache(sp, np.array([0, 0, 1, 1], np.float32),
                                  img_size=RES, patch_size=PATCH)
        ids, m = tokenize_with_mask(tok, cap, tiny.max_words)
        samples.append((clip_normalize(img), ids, m, seg))

    model = init_segclip(tiny, seed=0, device=dev)
    step = make_train_step(model, create_optimizer(model, cfg, t_total=STEPS), cfg)
    state = TrainState(step=0, seed=0)

    def make_batch(step_i):
        idx = np.random.default_rng(step_i).integers(0, n, B)
        batch = {k: np.stack([samples[i][j] for i in idx])
                 for j, k in enumerate(("image", "input_ids", "attention_mask", "image_seg"))}
        return to_device(batch, dev)[0]

    sims = []
    for i in range(STEPS):
        metrics = step(state, make_batch(i))
        if i % 10 == 0 or i == STEPS - 1:
            sims.append(float(metrics["sim_loss"]))

    chance = float(np.log(B))
    final = float(np.mean(sims[-3:]))
    print(f"\n{device}: final sim {final:.4f} (mean of the last 3 readings), chance "
          f"{chance:.4f}, bar {0.8 * chance:.4f}; readings "
          + " ".join(f"{s:.4f}" for s in sims))
    assert final < 0.8 * chance, (
        f"contrastive loss failed to learn: final {final:.3f} vs "
        f"chance {chance:.3f} (trajectory {sims})")
    assert np.isfinite(float(metrics["loss"]))
