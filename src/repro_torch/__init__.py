"""PyTorch/CUDA port of the tiled-CNN system in ``repro`` (the JAX reference).

Same module layout as ``repro``: each module here has one reference module
there and is held against it by ``tests/test_torch_*.py``.  The port imports
``torch`` and ``numpy`` only - never JAX, never ``repro``.  The conv kernel
the JAX package wrote in Pallas for the TPU is a hand-written CUDA kernel
here (``kernels/conv2d_tiled/csrc``), built with ``nvcc`` at first use.
"""
