"""Mamba2 SSD intra-chunk scan (B5): CUDA kernel, plain version and autograd op."""
