"""Mamba2 (SSD - state-space duality, arXiv:2405.21060): the full-sequence
block of ``repro/models/mamba2.py``.

Chunked SSD scan: within a chunk the sequence mixing is a masked (Q x Q)
quadratic form; across chunks a small state recurrence carries (B, H, N, P)
states.  ``mamba_block`` runs it through ``kernels.ssd_chunk.ops.ssd_scan``
(B5: the CUDA kernel on a card, its plain version on the CPU), as the
reference documents that op as a drop-in for ``_ssd_chunk_scan``.
``_ssd_chunk_scan`` is the plain version of the whole scan (``ssd_scan``'s
backward path); like the reference's it requires T % chunk == 0.  Both mask
the decay's exponent before ``exp`` (``kernels/ssd_chunk/ref.py``), so their
gradients stay finite where the reference's overflow (ROADMAP C.1).

Not here yet: the sequence-sharded scan (``seq_axis``; ``parallel/``) and
the decode path (``MambaState``, ``mamba_decode``; LM serving) - both raise
naming ROADMAP A.18.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sequence import seq_halo_conv1d
from repro_torch.kernels.ssd_chunk.ops import ssd_scan, ssd_scan_ref
from repro_torch.models.common import dense_init, rms_norm


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    return s, d_in, nh


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """Params on ``gen.device``; A_log, D and dt_bias stay fp32 in any model."""
    s, d_in, nh = _dims(cfg)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    in_dim = 2 * d_in + 2 * s.n_groups * s.d_state + nh
    dev = gen.device
    w_in = dense_init(gen, (cfg.d_model, in_dim), dtype)
    conv_w = dense_init(gen, (s.d_conv, conv_dim), dtype, fan_in=s.d_conv)
    w_out = dense_init(gen, (d_in, cfg.d_model), dtype, fan_in=d_in)
    return {
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=dev),   # A = -exp(A_log)
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((d_in,), dtype=dtype, device=dev),
        "w_out": w_out,
    }


def _ssd_chunk_scan(
    x: torch.Tensor,      # (B, T, H, P)
    dt: torch.Tensor,     # (B, T, H) softplus'd step sizes, fp32
    A: torch.Tensor,      # (H,) negative, fp32
    Bm: torch.Tensor,     # (B, T, G, N)
    Cm: torch.Tensor,     # (B, T, G, N)
    chunk: int,
    seq_axis: Optional[str] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (B,T,H,P) in x's type, final_state: (B,H,N,P)): the plain
    intra-chunk form and the cross-chunk recurrence of ``ssd_scan``, in fp32
    (fp64 stays fp64).  T must be a multiple of ``chunk``."""
    if seq_axis is not None:
        raise NotImplementedError("sequence-sharded SSD scan: ROADMAP A.18 (parallel/)")
    if x.shape[1] % chunk:
        raise ValueError(f"sequence length {x.shape[1]} is not a multiple of the chunk {chunk}")
    return ssd_scan_ref(x, dt, A, Bm, Cm, chunk)


class MambaState:
    """Decode cache (SSM state + conv ring): LM serving, ROADMAP A.18."""

    def __init__(self, *_a, **_k):
        raise NotImplementedError("Mamba2 decode cache (LM serving): ROADMAP A.18")

    @classmethod
    def init(cls, *_a, **_k):
        return cls()


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    s, d_in, nh = _dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_in, d_in, gn, gn, nh], dim=-1)


def mamba_block(
    params: dict,
    u: torch.Tensor,
    cfg: ModelConfig,
    *,
    seq_axis: Optional[str] = None,
) -> torch.Tensor:
    """Full-sequence Mamba2 block.  u: (B, T, D) -> (B, T, D)."""
    if seq_axis is not None:
        raise NotImplementedError("sequence-sharded Mamba2 block: ROADMAP A.18 (parallel/)")
    s, d_in, nh = _dims(cfg)
    b, t, _ = u.shape
    proj = u @ params["w_in"]
    z, x, Bm, Cm, dt = _split_proj(proj, cfg)
    xbc = torch.cat([x, Bm, Cm], dim=-1)
    xbc = seq_halo_conv1d(xbc, params["conv_w"], params["conv_b"], None)
    xbc = F.silu(xbc)
    gn = s.n_groups * s.d_state
    x, Bm, Cm = torch.split(xbc, [d_in, gn, gn], dim=-1)
    x = x.reshape(b, t, nh, s.head_dim)
    Bm = Bm.reshape(b, t, s.n_groups, s.d_state)
    Cm = Cm.reshape(b, t, s.n_groups, s.d_state)
    dtf = F.softplus(dt.to(torch.promote_types(dt.dtype, torch.float32)) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, _ = ssd_scan(x, dtf, A, Bm, Cm, min(s.chunk, t))
    y = y + x * params["D"][:, None].to(x.dtype)
    y = y.reshape(b, t, d_in)
    y = rms_norm(y * F.silu(z), params["norm_scale"])
    return y @ params["w_out"]


def mamba_decode(*_a, **_k):
    raise NotImplementedError("Mamba2 O(1) decode step (LM serving): ROADMAP A.18")
