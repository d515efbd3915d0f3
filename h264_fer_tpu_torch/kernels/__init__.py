"""Hand-written CUDA kernels (csrc/), their build step and their wrappers."""
