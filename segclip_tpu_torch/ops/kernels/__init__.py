"""Wrappers of the CUDA kernels, each beside its plain PyTorch version and
with a launch counter (`<wrapper>.launches`)."""
