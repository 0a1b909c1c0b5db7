"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each kernel subpackage: ``csrc/*.cu`` (the kernel), ``kernel.py`` (its
wrapper: the plain version for CPU tensors, the launch for CUDA tensors),
``ops.py`` (the autograd op) and ``ref.py`` (the plain torch version);
``conv2d_tiled`` also has ``backward.py`` (the dgrad and wgrad kernels
under the conv's backward).  Importing builds nothing: ``_build`` compiles
a kernel with ``nvcc`` at its first launch.  Re-exports the names of
``repro/kernels/__init__.py``; as there, the functions ``flash_attention``
and ``rmsnorm`` take the package attributes of their subpackages' names, so
a subpackage's module is imported by name (``from
repro_torch.kernels.rmsnorm import kernel``), not as an attribute.
"""
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.conv2d_tiled.backward import conv2d_dgrad_tile, conv2d_wgrad_tile
from repro_torch.kernels.conv2d_tiled.ops import conv2d
from repro_torch.kernels.rmsnorm.ops import rmsnorm
