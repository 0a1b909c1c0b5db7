"""Fused RMSNorm (B6): CUDA kernel, plain version and autograd op."""
