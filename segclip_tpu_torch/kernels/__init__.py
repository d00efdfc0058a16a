"""Build and load the CUDA kernels in csrc/."""
