"""Tiled VALID NHWC conv: CUDA kernel, plain version and padded wrapper."""
