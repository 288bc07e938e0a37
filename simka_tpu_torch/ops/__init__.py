"""Device operators on torch tensors and the hand-written CUDA kernels."""
