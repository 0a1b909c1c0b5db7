"""Parameter hand-over from the JAX reference to the port.

The two packages draw different numbers from the same seed, so parity tests
initialise params in JAX (``repro.core.spatial.init_stack_params``,
optionally after ``freeze_bn_stats``), convert them to numpy, and hand them
over here.  The layout needs no change: both packages keep HWIO filters and
per-channel vectors, under the same keys.  ``lm_params_from_jax`` does the
same for an LM param tree (``repro.models.lm.init_lm``): nested dicts and
lists, the segments' leaves stacked over their repeats, key for key.
A Whisper param tree (``repro.models.whisper.init_whisper``: the
stacked ``enc`` and ``dec`` layers) converts the same way.
``lm_caches_from_jax`` converts a JAX decode-cache list
(``repro.models.lm.init_caches``: ``KVCache``, ``MLACache`` and
``MambaState`` tuples of numpy arrays; ``init_whisper_caches``: a dict of
the self-attention ``KVCache`` and the cross K/V per decoder layer) into the
port's caches, so that parity tests start both packages from the same
non-empty caches.
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


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def lm_params_from_jax(tree, device: str | torch.device = "cuda"):
    """A JAX LM param tree (dicts and lists of numpy arrays, already on the
    host) -> the port's tree: the same structure and keys, tensors on
    ``device``."""
    device = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return _to_tensor(t, device)

    return conv(tree)


def lm_caches_from_jax(caches, device: str | torch.device = "cuda") -> list:
    """A JAX cache list (one ``KVCache(k, v, lengths)``, ``MLACache(c_kv, k_pe,
    lengths)``, ``MambaState(ssm, conv, length)`` or Whisper's ``{"self":
    KVCache, "cross_k", "cross_v"}`` per layer, leaves already numpy) -> the
    port's caches on ``device``: the same tensors (a ``WhisperCache`` for
    Whisper's dict), and a ``MambaState``'s scalar length broadcast to the
    port's one per slot."""
    from repro_torch.models.attention import KVCache, MLACache
    from repro_torch.models.mamba2 import MambaState
    from repro_torch.models.whisper import WhisperCache

    device = resolve_device(device)
    out = []
    for i, c in enumerate(caches):
        if isinstance(c, dict) and set(c) == {"self", "cross_k", "cross_v"}:
            (attn,) = lm_caches_from_jax([c["self"]], device)
            out.append(WhisperCache(attn, _to_tensor(c["cross_k"], device),
                                    _to_tensor(c["cross_v"], device)))
            continue
        fields = getattr(c, "_fields", None)
        if fields in (KVCache._fields, MLACache._fields):
            kind = KVCache if fields == KVCache._fields else MLACache
            out.append(kind(*(_to_tensor(t, device) for t in c)))
        elif fields == MambaState._fields:
            ssm, conv = _to_tensor(c.ssm, device), _to_tensor(c.conv, device)
            length = np.broadcast_to(np.asarray(c.length, np.int32), (ssm.shape[0],))
            out.append(MambaState(ssm, conv, _to_tensor(length, device)))
        else:
            raise TypeError(f"layer {i}: not a KVCache, MLACache, MambaState or Whisper layer: "
                            f"{type(c).__name__} {fields}")
    return out
