"""Pluggable conv-compute backends for the tiled executor (DESIGN.md §4).

The port of ``repro/core/backend.py``.  A backend computes the VALID 2-D
convolution of a halo-extended NHWC tile batch with an HWIO filter, adds the
bias when one is given, and may fuse the activations in its ``fused_acts``;
the executor applies any activation a backend cannot fuse, and always
applies batch norm itself.

Contract:
  fn(x, w, b, *, stride, act[, block_oh]) -> y
    x: (N, H, W, Cin) halo-extended tiles        w: (K, K, Cin, Cout)
    b: (Cout,) or None                           y: (N, OH, OW, Cout)
  - VALID padding only; halo delivery is the executor's job.
  - ``block_oh`` (optional) re-tiles the compute's output-row blocking; a
    backend without spatial blocking accepts and ignores it, and results
    never depend on it.
  - y.dtype == ``torch.promote_types(x.dtype, w.dtype)``.

``torch`` (the counterpart of ``xla``) runs ``F.conv2d``.  ``cuda`` (the
counterpart of ``pallas``) runs the hand-written kernel in
``kernels/conv2d_tiled``: on CUDA tensors it launches the kernel, on CPU
tensors it runs the kernel's plain version.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Optional

import torch
import torch.nn.functional as F

Activation = Callable[[torch.Tensor], torch.Tensor]

ACTIVATIONS: dict[str, Activation] = {
    "linear": lambda x: x,
    "relu": F.relu,
    "leaky": lambda x: torch.where(x > 0, x, 0.1 * x),   # darknet leaky slope
    "gelu": lambda x: F.gelu(x, approximate="tanh"),      # jax.nn.gelu's default
}

ConvFn = Callable[..., torch.Tensor]


def pad_for_valid(x: torch.Tensor, pad: int, *, pool: bool = False) -> torch.Tensor:
    """SAME-conv boundary of an NHWC map, materialised locally: zeros for
    convolutions, -inf for max pools (the untiled reference's init value)."""
    if pad == 0:
        return x
    return F.pad(x, (0, 0, pad, pad, pad, pad), value=float("-inf") if pool else 0.0)


@dataclasses.dataclass(frozen=True)
class ConvBackend:
    """One registered conv compute path (see module docstring contract)."""

    name: str
    fn: ConvFn
    fused_acts: frozenset[str]
    accepts_block_oh: bool = True

    def __call__(
        self,
        x: torch.Tensor,
        w: torch.Tensor,
        b: Optional[torch.Tensor],
        *,
        stride: int,
        act: str,
        block_oh: Optional[int] = None,
    ) -> torch.Tensor:
        if block_oh is None:
            return self.fn(x, w, b, stride=stride, act=act)
        if not self.accepts_block_oh:
            raise ValueError(
                f"conv backend {self.name!r} does not accept block_oh; "
                "add a block_oh kwarg to its fn (ignoring it is fine) or "
                "build the plan with block_oh=None"
            )
        return self.fn(x, w, b, stride=stride, act=act, block_oh=block_oh)


_REGISTRY: dict[str, ConvBackend] = {}


def register_conv_backend(
    name: str, fn: ConvFn, *, fused_acts: tuple[str, ...] = ("linear",)
) -> ConvBackend:
    try:
        sig = inspect.signature(fn)
        accepts = "block_oh" in sig.parameters or any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()
        )
    except (TypeError, ValueError):    # builtins/partials without signatures
        accepts = True
    be = ConvBackend(name, fn, frozenset(fused_acts), accepts_block_oh=accepts)
    _REGISTRY[name] = be
    return be


def get_conv_backend(name: str) -> ConvBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown conv backend {name!r}; registered: {conv_backend_names()}"
        ) from None


def conv_backend_names() -> list[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# torch: the oracle path (F.conv2d)
# ---------------------------------------------------------------------------


def _torch_conv(x, w, b, *, stride: int, act: str, block_oh: int | None = None):
    # block_oh is a spatial-blocking hint F.conv2d has no knob for: accepted
    # (contract) and ignored.  F.conv2d rejects mixed dtypes, so promote
    # explicitly (bf16 activations x fp32 filters -> fp32), as the xla
    # backend does.
    dt = torch.promote_types(x.dtype, w.dtype)
    y = F.conv2d(
        x.to(dt).permute(0, 3, 1, 2), w.to(dt).permute(3, 2, 0, 1), stride=stride
    ).permute(0, 2, 3, 1)
    if b is not None:
        y = y + b
    return ACTIVATIONS[act](y).contiguous()


register_conv_backend("torch", _torch_conv, fused_acts=tuple(ACTIVATIONS))


# ---------------------------------------------------------------------------
# cuda: the hand-written kernel (kernels/conv2d_tiled)
# ---------------------------------------------------------------------------


def _cuda_conv(x, w, b, *, stride: int, act: str, block_oh: int | None = None):
    from repro_torch.kernels.conv2d_tiled.ops import conv2d

    if b is None:
        # The zero bias at the promoted dtype, as the pallas backend adds it:
        # under mixed precision the epilogue adds it at the result precision.
        b = torch.zeros(w.shape[-1], dtype=torch.promote_types(x.dtype, w.dtype),
                        device=w.device)
    return conv2d(x.contiguous(), w.contiguous(), b, stride, 0, act, block_oh)


register_conv_backend("cuda", _cuda_conv, fused_acts=("linear", "relu", "leaky"))
