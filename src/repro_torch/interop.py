"""Parameter hand-over from the JAX reference to the port.

The two packages draw different numbers from the same seed, so parity tests
initialise params in JAX (``repro.core.spatial.init_stack_params``,
optionally after ``freeze_bn_stats``), convert them to numpy, and hand them
over here.  The layout needs no change: both packages keep HWIO filters and
per-channel vectors, under the same keys.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.launch.mesh import resolve_device

PARAM_KEYS = ("w", "b", "bn_scale", "bn_bias", "bn_mean", "bn_var")


def params_from_jax(
    params: Sequence[Mapping[str, np.ndarray]], device: str | torch.device = "cuda"
) -> list[dict[str, torch.Tensor]]:
    """A JAX params stack (list of per-layer dicts of arrays, already on the
    host as numpy) -> the port's params: the same keys, tensors on
    ``device``."""
    device = resolve_device(device)
    out = []
    for i, layer in enumerate(params):
        unknown = set(layer) - set(PARAM_KEYS)
        if unknown:
            raise KeyError(f"layer {i}: unknown param keys {sorted(unknown)}")
        out.append(
            {k: torch.from_numpy(np.array(v, copy=True)).to(device) for k, v in layer.items()}
        )
    return out
