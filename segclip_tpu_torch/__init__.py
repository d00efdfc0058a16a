"""segclip_tpu_torch — the PyTorch/CUDA port of segclip_tpu for one NVIDIA
H100 (Hopper, sm_90a).

It follows the JAX package's layout and names; its public functions keep the
JAX layouts (images NHWC, attention operands (B, L, H·64), group maps
(B, G, L)) so that the two can be compared like with like. It imports torch
and never jax or flax.

Layout (bottom-up):
  csrc/         hand-written CUDA kernels (attention forward and backward,
                group assignment with and without Gumbel noise)
  kernels/      nvcc build-on-first-use + ctypes loading
  ops/          plain tensor functions; ops/kernels wraps each CUDA kernel
                beside its plain PyTorch version
  models/       nn.Modules in the reference state-dict key layout, and the
                pretraining losses
  parallel/     collectives of the contrastive loss (world size 1), the
                host → device batch prefetch
  train/        parameter groups, AdaptAdamW, the training step and loop
  checkpoint/   JAX params / reference .bin → the port's state dict;
                torch.save checkpoints and resume
  native/       C++ Felzenszwalb superpixels and SGR record reader (g++,
                ctypes)
  data/         tokenizer, transforms, SGR records, superpixels, the shapes
                corpus, the input pipeline
  evalseg/      text bank and zero-shot segmentation inference
  cli/          command-line entry points (eval_zeroshot, train, prepare_data)
  utils/        device resolution, logging, profiling
"""

__version__ = "0.1.0"
