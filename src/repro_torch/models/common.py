"""Shared building blocks: norms, RoPE, activations, initialisers
(``repro/models/common.py``).

``rms_norm`` runs the fused RMSNorm op (B6: the CUDA kernel on a card, its
plain version on the CPU).  Initialisers draw from an explicit
``torch.Generator`` (on the device the params live on) in fp32, scale the
draw in place and cast it, so a draw holds one fp32 buffer: the port's
numbers differ from ``jax.random``'s, so parity tests hand JAX's params
over with ``interop.lm_params_from_jax``.  Inside ``draws_into(sink)`` a
draw is cast into the tensor ``sink`` hands out for it instead of a new one
(``models/lm.py:init_lm`` writes each draw into its stacked leaf's row).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm.ops import rmsnorm


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return rmsnorm(x, scale, eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.promote_types(dt, torch.float32))
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(dt) * scale
    if bias is not None:
        y = y + bias
    return y


def apply_norm(kind: str, x: torch.Tensor, p: dict) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    if kind == "layernorm":
        return layer_norm(x, p["scale"], p.get("bias"))
    raise ValueError(kind)


def init_norm(kind: str, d: int, dtype=torch.float32, device="cpu") -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


ACT = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),    # jax.nn.gelu's default
    "relu": F.relu,
}


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, Dh); positions: (B, T) or (T,) ints.  Angles in fp32,
    the result cast back to x's type."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs      # (B, T, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the Dh/2 frequency slots are split into
    ``sections`` (temporal, height, width), each rotated by its own position
    stream.  x: (B, T, H, Dh); positions: (3, B, T).  Angles in fp32, the
    result cast back to x's type."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    if sum(sections) != dh // 2:
        raise ValueError(f"M-RoPE sections {sections} must cover the {dh // 2} frequency slots")
    angs, off = [], 0
    for si, sec in enumerate(sections):
        pos = positions[si][..., None].to(torch.float32)          # (B, T, 1)
        angs.append(pos * freqs[off:off + sec])
        off += sec
    ang = torch.cat(angs, dim=-1)                                  # (B, T, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------


# the sink of ``draws_into``: (fp32 draw, dtype) -> the tensor that now holds
# it in ``dtype``; None casts a draw into a new tensor
_DRAW_SINK: contextvars.ContextVar = contextvars.ContextVar("draw_sink", default=None)


@contextlib.contextmanager
def draws_into(sink):
    """Within the block, each draw of ``dense_init`` / ``embed_init`` is
    handed to ``sink(w, dtype)``, which writes it where it belongs and
    returns that tensor, so no cast copy of a draw is made."""
    token = _DRAW_SINK.set(sink)
    try:
        yield
    finally:
        _DRAW_SINK.reset(token)


def _cast_draw(w: torch.Tensor, dtype) -> torch.Tensor:
    sink = _DRAW_SINK.get()
    return w.to(dtype) if sink is None else sink(w, dtype)


def dense_init(gen: torch.Generator, shape, dtype, fan_in=None) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = (1.0 / max(fan_in, 1)) ** 0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return _cast_draw(w.mul_(scale), dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return _cast_draw(w.mul_(0.02), dtype)
