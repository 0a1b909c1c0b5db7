"""Platform shims: ``repro/compat.py``.

``overlap_supported`` says whether a device can hide the overlap schedule's
collectives behind compute: a card can (the virtual mesh's exchanges are
kernels on streams beside the interior's), the host CPU runs them inline.
``core/fusion.py``'s ``schedule="auto"`` resolves to "sync" where it is
False, as the reference's does on the host CPU backend.

The reference's other names have no counterpart here: ``XLA_GPU_OVERLAP_FLAGS``
and ``enable_overlap_xla_flags`` set XLA flags, and the port runs no XLA;
``keystr_slash``'s path spelling (``params/0/moe/w_gate``) is the one
``ckpt/manager.py:map_with_path`` hands every leaf, which the checkpoint
manifests and the sharding rules key on.
"""
from __future__ import annotations

from typing import Optional

import torch


def overlap_supported(device: Optional[str | torch.device] = None) -> bool:
    """True on a CUDA device.  ``device`` None means the default device:
    the card when one is present, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type == "cuda"
