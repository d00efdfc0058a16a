"""segclip_tpu_torch — the PyTorch/CUDA port of segclip_tpu for one NVIDIA
H100 (Hopper, sm_90a).

It follows the JAX package's layout and names; its public functions keep the
JAX layouts (images NHWC, attention operands (B, L, H·64), group maps
(B, G, L)) so that the two can be compared like with like. It imports torch
and never jax or flax.

Layout (bottom-up):
  csrc/         hand-written CUDA kernels (attention forward, group assignment)
  kernels/      nvcc build-on-first-use + ctypes loading
  ops/          plain tensor functions; ops/kernels wraps each CUDA kernel
                beside its plain PyTorch version
  models/       nn.Modules in the reference state-dict key layout
  checkpoint/   JAX params / reference .bin → the port's state dict
  evalseg/      text bank and zero-shot segmentation inference
  cli/          command-line entry points
  utils/        device resolution
"""

__version__ = "0.1.0"
