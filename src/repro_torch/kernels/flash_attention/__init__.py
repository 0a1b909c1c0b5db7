"""Flash attention forward (B4): CUDA kernel, plain version and autograd op."""
