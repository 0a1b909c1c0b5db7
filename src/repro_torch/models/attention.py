"""Full-sequence GQA attention for training (``repro/models/attention.py``).

``attention`` runs the flash-attention op (B4: the CUDA kernel on a card,
its plain version on the CPU), whose mask is the sequence index, wherever
the mask the positions give is that one: the default ``arange`` positions
(every call of the LM training path, Whisper's encoder and decoder), M-RoPE's
``(3, B, T)`` streams (masked by the index: ROADMAP C.14, below), and a
non-causal call with no window, which masks nothing (Whisper's
cross-attention, whose ``kv_override`` keys outnumber the queries).  Other
positions take the plain ``_sdpa``: by default the reference's "auto" mode,
naive below 2048 keys and blocked streaming above; ``attention_impl`` selects
another mode for the current thread ("naive", "blocked", or the dry run's
counting "stub", which alone also stands in for the flash op).
``_sdpa_blocked`` is also the op's backward.  The reference's mesh
constraints are identities on one device (``parallel/api.py:constrain``)
and are not called.

M-RoPE (Qwen2-VL): ``_rope_qk`` rotates q and k by the three position
streams (``models/common.py:apply_mrope``).  The reference then masks by the
temporal stream (``positions[0]``), under which every patch of an image,
sharing one temporal position, sees the patches after it (C.14); here the
causal mask runs by the sequence index, as a causal LM's must.  The decode
broadcasts the slot's length to the three streams, as the reference's does.
``cross_attention_kv`` is Whisper's encoder-side K/V.

``KVCache`` and ``decode_attention`` are the serving path's one-token
step: the cache is preallocated ``(B, S, Hkv, Dh)`` tensors plus per-slot
``lengths``, written in place, so every index stays on the device.  The
decode scores go through the plain ``_sdpa`` (naive at one query), as the
reference's go through XLA.

MLA (DeepSeek-V3's multi-head latent attention): ``mla_attention`` is the
training and prefill form (low-rank q and kv, each normed by B6, a decoupled
RoPE part with one shared key head, the plain ``_sdpa`` at qk head dim
``dn + dr`` and v head dim ``dv``: outside B4's ``k.shape == v.shape``, as
the reference's runs through XLA and not its Pallas kernel);
``_decode_mla`` the absorbed decode over an ``MLACache`` of the compressed
``c_kv`` and the rotated ``k_pe`` rows, scored in fp32 in the compressed
space.

``decode_attend_seq_sharded`` is the sequence-sharded (flash-decode) form
of the decode's scores: the cache's rows split into the shards of the
active mesh's ``seq_shard`` axis, a partial softmax per shard, one rescale
to combine them - what SPMD makes of the reference's constrained einsums.
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF, scaled_q
from repro_torch.models.common import apply_mrope, apply_rope, dense_init, rms_norm
from repro_torch.parallel.api import axis_size, logical_spec


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d = cfg.d_model
    dh = cfg.resolved_head_dim
    dev = gen.device
    if cfg.mla is not None:
        m = cfg.mla
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        h = cfg.n_heads
        return {
            "w_dq": dense_init(gen, (d, m.q_lora_rank), dtype),
            "q_norm": torch.ones((m.q_lora_rank,), dtype=dtype, device=dev),
            "w_uq": dense_init(gen, (m.q_lora_rank, h, qk_dim), dtype, fan_in=m.q_lora_rank),
            "w_dkv": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim), dtype),
            "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dtype, device=dev),
            "w_uk": dense_init(gen, (m.kv_lora_rank, h, m.qk_nope_head_dim), dtype,
                               fan_in=m.kv_lora_rank),
            "w_uv": dense_init(gen, (m.kv_lora_rank, h, m.v_head_dim), dtype,
                               fan_in=m.kv_lora_rank),
            "w_o": dense_init(gen, (h, m.v_head_dim, d), dtype, fan_in=h * m.v_head_dim),
        }
    p = {
        "w_q": dense_init(gen, (d, cfg.n_heads, dh), dtype),
        "w_k": dense_init(gen, (d, cfg.n_kv_heads, dh), dtype),
        "w_v": dense_init(gen, (d, cfg.n_kv_heads, dh), dtype),
        "w_o": dense_init(gen, (cfg.n_heads, dh, d), dtype, fan_in=cfg.n_heads * dh),
    }
    if cfg.qkv_bias:
        p["b_q"] = torch.zeros((cfg.n_heads, dh), dtype=dtype, device=dev)
        p["b_k"] = torch.zeros((cfg.n_kv_heads, dh), dtype=dtype, device=dev)
        p["b_v"] = torch.zeros((cfg.n_kv_heads, dh), dtype=dtype, device=dev)
    if cfg.attn_out_bias:
        p["b_o"] = torch.zeros((d,), dtype=dtype, device=dev)
    return p


# ---------------------------------------------------------------------------
# Core softmax attention (plain torch)
# ---------------------------------------------------------------------------


def _mask(q_pos, k_pos, causal: bool, window: Optional[int]):
    """(B, Tq, Tk) bool from (B, Tq) / (B, Tk) positions, or None."""
    mask = None
    if causal:
        mask = q_pos[:, :, None] >= k_pos[:, None, :]
    if window is not None:
        w = q_pos[:, :, None] - k_pos[:, None, :] < window
        mask = w if mask is None else mask & w
    return mask


def _sdpa_naive(
    q: torch.Tensor,            # (B, Tq, Hq, Dh)
    k: torch.Tensor,            # (B, Tk, Hkv, Dh)
    v: torch.Tensor,            # (B, Tk, Hkv, Dv)
    q_pos: torch.Tensor,        # (B, Tq) or (Tq,)
    k_pos: torch.Tensor,        # (B, Tk) or (Tk,)
    *,
    causal: bool,
    window: Optional[int],
    k_valid: Optional[torch.Tensor] = None,   # (B, Tk) bool
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else dh ** -0.5
    qf = scaled_q(q, scale)
    acc = qf.dtype
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qf.reshape(b, tq, hkv, rep, dh), k.to(acc))
    if q_pos.dim() == 1:
        q_pos = q_pos[None, :]
    if k_pos.dim() == 1:
        k_pos = k_pos[None, :]
    mask = _mask(q_pos, k_pos, causal, window)
    if mask is None:
        mask = torch.ones((b, tq, tk), dtype=torch.bool, device=q.device)
    mask = mask.expand(b, tq, tk)
    if k_valid is not None:
        mask = mask & k_valid[:, None, :]
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v.to(acc))
    return out.reshape(b, tq, hq, v.shape[-1]).to(q.dtype)


def _pick_chunk(t: int, c: int) -> int:
    while c > 16 and t % c:
        c //= 2
    return c if t % c == 0 else t


def _kv_block(qi, qp, kj, vj, kp, kv_ok, m, l, acc, causal, window):
    """One KV chunk of the streaming softmax: the running (m, l, acc) of a
    query chunk updated with keys ``kj`` / values ``vj``."""
    s = torch.einsum("bqhrd,bkhd->bhrqk", qi, kj)
    mask = kv_ok[:, None, :]
    pos_mask = _mask(qp, kp, causal, window)
    if pos_mask is not None:
        mask = mask & pos_mask
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m2 = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m2[..., None])
    alpha = torch.exp(m - m2)
    l2 = l * alpha + p.sum(dim=-1)
    acc2 = acc * alpha[..., None] + torch.einsum("bhrqk,bkhd->bhrqd", p, vj)
    return m2, l2, acc2


def _sdpa_blocked(
    q, k, v, q_pos, k_pos, *, causal, window, k_valid=None, scale=None,
    q_chunk=1024, kv_chunk=1024,
):
    """Streaming-softmax (flash) attention over KV chunks: a loop over query
    chunks, an inner loop over KV chunks carrying the running (max, denom,
    weighted acc).  Each KV step is checkpointed, as in the reference, so
    the backward recomputes a chunk's probabilities instead of keeping the
    whole (Tq x Tk) tensor."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    rep = hq // hkv
    scale = scale if scale is not None else dh ** -0.5
    qc = _pick_chunk(tq, q_chunk)
    kc = _pick_chunk(tk, kv_chunk)
    nq, nk = tq // qc, tk // kc
    if q_pos.dim() == 1:
        q_pos = q_pos[None]
    if k_pos.dim() == 1:
        k_pos = k_pos[None]
    q_pos = q_pos.expand(b, tq)
    k_pos = k_pos.expand(b, tk)

    qf = scaled_q(q, scale)
    acc_t = qf.dtype
    qf = qf.reshape(b, nq, qc, hkv, rep, dh)
    ks = k.to(acc_t).reshape(b, nk, kc, hkv, dh)
    vs = v.to(acc_t).reshape(b, nk, kc, hkv, dv)
    kps = k_pos.reshape(b, nk, kc)
    kvs = (k_valid.reshape(b, nk, kc) if k_valid is not None
           else torch.ones((b, nk, kc), dtype=torch.bool, device=q.device))
    qps = q_pos.reshape(b, nq, qc)

    outs = []
    for i in range(nq):
        qi, qp = qf[:, i], qps[:, i]
        m = torch.full((b, hkv, rep, qc), NEG_INF, dtype=acc_t, device=q.device)
        l = torch.zeros((b, hkv, rep, qc), dtype=acc_t, device=q.device)
        acc = torch.zeros((b, hkv, rep, qc, dv), dtype=acc_t, device=q.device)
        for j in range(nk):
            m, l, acc = checkpoint(_kv_block, qi, qp, ks[:, j], vs[:, j], kps[:, j], kvs[:, j],
                                   m, l, acc, causal, window, use_reentrant=False,
                                   preserve_rng_state=False)      # draws nothing
        out = acc / torch.clamp(l, min=1e-30)[..., None]      # (b,hkv,rep,qc,dv)
        outs.append(out.permute(0, 3, 1, 2, 4))              # (b,qc,hkv,rep,dv)
    return torch.cat(outs, dim=1).reshape(b, tq, hq, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention implementation selector (the reference's ``attention_impl``)
#
# "auto":    blocked for Tk >= 2048 (and Tq > 1), else naive - the default.
# "naive":   the (B, H, Tq, Tk) logits materialised (``_sdpa_naive``).
# "blocked": the streaming softmax over KV chunks (``_sdpa_blocked``) at the
#            context's ``q_chunk`` / ``kv_chunk``.
# "stub":    a near-zero-FLOP stand-in that keeps the shape and the gradient
#            path (``_sdpa_stub``), for counting alone: the dry run adds the
#            flash kernel's analytic terms back (analysis/roofline.py).
#
# The modes choose how ``_sdpa`` computes.  ``attention``'s flash route (B4)
# is replaced by "stub" alone: "naive" and "blocked" leave B4 on the card's
# path, so no mode is a fallback that hides the kernel.
# ---------------------------------------------------------------------------

ATTN_MODES = ("auto", "naive", "blocked", "stub")


class _AttnMode(threading.local):
    def __init__(self):
        self.mode = "auto"
        self.q_chunk = 1024
        self.kv_chunk = 1024


_ATTN = _AttnMode()


@contextlib.contextmanager
def attention_impl(mode: str, *, q_chunk: int = 1024, kv_chunk: int = 1024):
    """Select the attention implementation for the current thread (above);
    the previous one comes back on exit."""
    if mode not in ATTN_MODES:
        raise ValueError(f"attention_impl mode {mode!r}: one of {ATTN_MODES}")
    prev = (_ATTN.mode, _ATTN.q_chunk, _ATTN.kv_chunk)
    _ATTN.mode, _ATTN.q_chunk, _ATTN.kv_chunk = mode, q_chunk, kv_chunk
    try:
        yield
    finally:
        _ATTN.mode, _ATTN.q_chunk, _ATTN.kv_chunk = prev


def captured_impl():
    """A function that re-enters the implementation selected now, for a
    checkpoint's recomputation, which runs on autograd's thread for a card
    (``parallel/api.py:captured_ctx`` does the same for the mesh)."""
    mode, qc, kc = _ATTN.mode, _ATTN.q_chunk, _ATTN.kv_chunk
    return lambda: attention_impl(mode, q_chunk=qc, kv_chunk=kc)


def _sdpa_stub(q, k, v, q_pos=None, k_pos=None, **_kw):
    """Near-zero-FLOP stand-in of the same shape: each query's output is the
    mean of its KV head's values, plus q and k times zero, so q, k and v all
    stay on the gradient path."""
    b, tq, hq, _ = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    rep = hq // hkv
    vm = v.float().mean(dim=1)                                  # (b, hkv, dv)
    out = vm[:, None, :, None, :].expand(b, tq, hkv, rep, dv).reshape(b, tq, hq, dv)
    zero = (q.sum(dim=-1) + k.sum(dim=(1, 2, 3))[:, None, None]) * 0.0
    return (out + zero[..., None]).to(q.dtype)


def _sdpa(q, k, v, q_pos, k_pos, *, causal, window, k_valid=None, scale=None) -> torch.Tensor:
    """The plain attention in the selected mode (``attention_impl``); "auto"
    is blocked for Tk >= 2048 (and Tq > 1), naive below."""
    mode = _ATTN.mode
    if mode == "auto":
        mode = "blocked" if (k.shape[1] >= 2048 and q.shape[1] > 1) else "naive"
    if mode == "stub":
        return _sdpa_stub(q, k, v, q_pos, k_pos)
    if mode == "blocked":
        return _sdpa_blocked(q, k, v, q_pos, k_pos, causal=causal, window=window,
                             k_valid=k_valid, scale=scale, q_chunk=_ATTN.q_chunk,
                             kv_chunk=_ATTN.kv_chunk)
    return _sdpa_naive(q, k, v, q_pos, k_pos, causal=causal, window=window,
                       k_valid=k_valid, scale=scale)


# ---------------------------------------------------------------------------
# GQA attention (train / prefill)
# ---------------------------------------------------------------------------


def _qkv(params, x, cfg: ModelConfig):
    q = torch.einsum("btd,dhe->bthe", x, params["w_q"])
    k = torch.einsum("btd,dhe->bthe", x, params["w_k"])
    v = torch.einsum("btd,dhe->bthe", x, params["w_v"])
    if cfg.qkv_bias:
        q = q + params["b_q"]
        k = k + params["b_k"]
        v = v + params["b_v"]
    return q, k, v


def _rope_qk(q, k, positions, cfg: ModelConfig):
    if not cfg.use_rope:
        return q, k
    if cfg.mrope_sections is not None:
        # positions: (3, B, T) multimodal streams
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    elif positions is not None:
        if cfg.rope_pct < 1.0:
            rot = int(q.shape[-1] * cfg.rope_pct)
            rot -= rot % 2
            q = torch.cat([apply_rope(q[..., :rot], positions, cfg.rope_theta), q[..., rot:]],
                          dim=-1)
            k = torch.cat([apply_rope(k[..., :rot], positions, cfg.rope_theta), k[..., rot:]],
                          dim=-1)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    return q, k


def attention(
    params: dict,
    x: torch.Tensor,
    positions: Optional[torch.Tensor],
    cfg: ModelConfig,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    kv_override: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    arange_positions: bool = False,
) -> torch.Tensor:
    """Full-sequence attention.  x: (B, T, D) -> (B, T, D).
    ``arange_positions`` says that ``positions`` are the default
    ``arange(T)`` for every row (``apply_lm`` knows when it made them).
    ``kv_override`` (cross-attention) is the precomputed ``(k, v)`` of
    ``cross_attention_kv``, at key positions ``arange(Tk)``; only q is
    projected from x.  The flash op runs wherever its index mask is the
    positions' mask (the module's docstring)."""
    if cfg.mla is not None:
        return mla_attention(params, x, positions, cfg, causal=causal)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None]
        rope_positions = None     # no rope (whisper-style learned/sinusoid)
        arange_positions = True
    else:
        rope_positions = positions
    if kv_override is not None:
        q = torch.einsum("btd,dhe->bthe", x, params["w_q"])
        if cfg.qkv_bias:
            q = q + params["b_q"]
        k, v = kv_override
        kpos = torch.arange(k.shape[1], device=x.device)
    else:
        q, k, v = _qkv(params, x, cfg)
        if rope_positions is not None:
            q, k = _rope_qk(q, k, rope_positions, cfg)
        kpos = None
    if arange_positions or positions.dim() == 3 or (not causal and window is None):
        # the flash op masks by the sequence index (M-RoPE's streams too:
        # C.14); the counting stub stands in for it as for ``_sdpa``
        out = (_sdpa_stub(q, k, v) if _ATTN.mode == "stub"
               else flash_attention(q, k, v, causal, window))
    else:
        out = _sdpa(q, k, v, positions, positions if kpos is None else kpos, causal=causal,
                    window=window)
    # "bthe,hed->btd" as one matmul over a view of w_o: torch.einsum copies
    # w_o into (e, h) order first, and remat="dots" tells the projection by
    # its weight (models/lm.py:_block_output_weights)
    y = out.flatten(2) @ params["w_o"].flatten(0, 1)
    if cfg.attn_out_bias:
        y = y + params["b_o"]
    return y


def cross_attention_kv(params: dict, enc: torch.Tensor, cfg: ModelConfig):
    """Cross-attention K/V from the encoder's output (Whisper): each (B, Tk,
    Hkv, Dh)."""
    k = torch.einsum("btd,dhe->bthe", enc, params["w_k"])
    v = torch.einsum("btd,dhe->bthe", enc, params["w_v"])
    if cfg.qkv_bias:
        k = k + params["b_k"]
        v = v + params["b_v"]
    return k, v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------


def _mla_q(params, x, positions, cfg: ModelConfig):
    """(q_nope, rotated q_pe), each (B, T, H, .), from x through the low-rank
    q (``q_norm`` by B6)."""
    m = cfg.mla
    cq = rms_norm(x @ params["w_dq"], params["q_norm"])
    q = torch.einsum("btr,rhe->bthe", cq, params["w_uq"])          # (B, T, H, dn + dr)
    q_nope, q_pe = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_pe, positions, cfg.rope_theta)


def _mla_kv(params, x, positions, cfg: ModelConfig):
    """(normed c_kv (B, T, rank), rotated k_pe (B, T, dr)): the compressed
    rows a token adds to the cache.  ``kv_norm`` normalises a strided view of
    the projection (rows of rank + dr); B6's op copies it contiguous."""
    m = cfg.mla
    ckv_full = x @ params["w_dkv"]                                # (B, T, rank + dr)
    c_kv, k_pe = torch.split(ckv_full, [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = rms_norm(c_kv, params["kv_norm"])
    k_pe = apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]   # 1 shared head
    return c_kv, k_pe


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def mla_attention(params, x, positions, cfg: ModelConfig, *, causal=True) -> torch.Tensor:
    """The reference's ``mla_attention``: x (B, T, D) -> (B, T, D).  The one
    rotated key head ``k_pe`` is broadcast to every head beside ``k_nope``,
    and the scores run through the plain ``_sdpa``."""
    m = cfg.mla
    b, t, _ = x.shape
    q_nope, q_pe = _mla_q(params, x, positions, cfg)
    c_kv, k_pe = _mla_kv(params, x, positions, cfg)
    k_nope = torch.einsum("btr,rhe->bthe", c_kv, params["w_uk"])
    v = torch.einsum("btr,rhe->bthe", c_kv, params["w_uv"])
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    k_pe = k_pe[:, :, None, :].expand(b, t, cfg.n_heads, m.qk_rope_head_dim)
    k_full = torch.cat([k_nope, k_pe], dim=-1)
    out = _sdpa(q_full, k_full, v, positions, positions, causal=causal, window=None,
                scale=_mla_scale(cfg))
    return torch.einsum("bthe,hed->btd", out, params["w_o"])


# ---------------------------------------------------------------------------
# KV caches + single-token decode
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Standard GQA cache.  k/v: (B, S, Hkv, Dh) in the activation type;
    lengths: (B,) int32, per slot.  ``decode_attention`` writes the three
    tensors in place; ``slot(i)`` is a batch-1 view of slot ``i`` whose
    writes land in these tensors."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @classmethod
    def init(cls, b, s, hkv, dh, dtype, device="cpu"):
        return cls(
            torch.zeros((b, s, hkv, dh), dtype=dtype, device=device),
            torch.zeros((b, s, hkv, dh), dtype=dtype, device=device),
            torch.zeros((b,), dtype=torch.int32, device=device),
        )

    def slot(self, i: int) -> "KVCache":
        return KVCache(*(t[i:i + 1] for t in self))


class MLACache(NamedTuple):
    """MLA compressed cache: c_kv (B, S, rank) and the rotated k_pe (B, S,
    dr) in the activation type; lengths (B,) int32, per slot.  Written in
    place by ``_decode_mla``; ``slot(i)`` is a batch-1 view of slot ``i``."""

    c_kv: torch.Tensor
    k_pe: torch.Tensor
    lengths: torch.Tensor

    @classmethod
    def init(cls, b, s, rank, dr, dtype, device="cpu"):
        return cls(
            torch.zeros((b, s, rank), dtype=dtype, device=device),
            torch.zeros((b, s, dr), dtype=dtype, device=device),
            torch.zeros((b,), dtype=torch.int32, device=device),
        )

    def slot(self, i: int) -> "MLACache":
        return MLACache(*(t[i:i + 1] for t in self))


def _write_slot(pos: torch.Tensor, s: int, ring: bool) -> torch.Tensor:
    """The cache row a token at position ``pos`` goes to: the ring slot of a
    sliding window, else the position clamped to the last row."""
    return pos % s if ring else torch.clamp(pos, max=s - 1)


def decode_attention(
    params: dict,
    x: torch.Tensor,              # (B, 1, D)
    cache: KVCache,
    cfg: ModelConfig,
    *,
    window: Optional[int] = None,
    seq_sharded: bool = False,
) -> tuple[torch.Tensor, KVCache]:
    """One-token decode, as the reference's.  Writes the new K/V row and
    advances ``lengths`` in place.  ``seq_sharded`` scores the cache by
    ``decode_attend_seq_sharded`` (an MLA layer ignores it, as the
    reference's)."""
    if cfg.mla is not None:
        return _decode_mla(params, x, cache, cfg)
    b = x.shape[0]
    pos = cache.lengths.long()                     # (B,) per-slot positions
    positions = pos[:, None]
    q, k_new, v_new = _qkv(params, x, cfg)
    if cfg.mrope_sections is not None:
        # a decoded token's three streams are its position
        q, k_new = _rope_qk(q, k_new, positions.expand(3, *positions.shape), cfg)
    else:
        q, k_new = _rope_qk(q, k_new, positions, cfg)
    s = cache.k.shape[1]
    ring = window is not None and s <= window
    slot = _write_slot(pos, s, ring)
    bidx = torch.arange(b, device=x.device)
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        buf.index_put_((bidx, slot), new[:, 0].to(buf.dtype))
    row = torch.arange(s, device=x.device)[None]   # (1, S)
    if ring:
        # absolute position of each ring slot, per batch row
        wrap = ((pos // s) * s)[:, None]
        kpos = torch.where(row <= (pos % s)[:, None], wrap + row, wrap - s + row)
    else:
        kpos = row.expand(b, s)
    # kpos >= 0 excludes never-written ring slots: without it the zero keys
    # count as valid at early positions and dilute the softmax denominator
    valid = (kpos <= positions) & (kpos >= 0)
    if seq_sharded:
        out = decode_attend_seq_sharded(q, cache.k, cache.v, positions, kpos, valid, window)
    else:
        out = _sdpa(q, cache.k, cache.v, positions, kpos, causal=True, window=window,
                    k_valid=valid)
    y = torch.einsum("bthe,hed->btd", out, params["w_o"])
    if cfg.attn_out_bias:
        y = y + params["b_o"]
    cache.lengths.add_(1)
    return y, cache


def decode_attend_seq_sharded(q, k, v, q_pos, k_pos, valid, window):
    """Flash-decode over a cache whose S rows are split into the shards of
    the active mesh's ``seq_shard`` axis (``logical_spec`` of the
    reference's constraint; 1 shard without a mesh or where S does not
    divide): per shard, in fp32 (fp64 stays fp64), the masked scores' max,
    the sum of their exponentials and the exponential-weighted values; then
    one rescale by ``exp(max_shard - max)`` combines the shards.  The masks
    are the reference's: causal, ``valid`` (``kpos >= 0`` and written) and
    the window.  q (B, Tq, Hq, Dh), k / v (B, S, Hkv, D), q_pos (B, Tq),
    k_pos and valid (B, S) -> (B, Tq, Hq, Dv) in q's type."""
    b, tq, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    n = axis_size(logical_spec(("batch", "seq_shard", "kv_heads", None), k.shape)[1])
    acc = torch.promote_types(q.dtype, torch.float32)
    qf = (q * dh ** -0.5).to(acc).reshape(b, tq, hkv, rep, dh)
    kf = k.to(acc).reshape(b, n, s // n, hkv, dh)
    vf = v.to(acc).reshape(b, n, s // n, hkv, v.shape[-1])
    logits = torch.einsum("bqhrd,bjkhd->bjhrqk", qf, kf)          # (B, n, Hkv, rep, Tq, S/n)
    mask = (q_pos[:, :, None] >= k_pos[:, None, :]) & valid[:, None, :]
    if window is not None:
        mask = mask & (q_pos[:, :, None] - k_pos[:, None, :] < window)
    mask = mask.reshape(b, tq, n, s // n).transpose(1, 2)[:, :, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    mx = torch.amax(logits, dim=-1, keepdim=True)                 # each shard's max
    ex = torch.exp(logits - mx)
    den = torch.sum(ex, dim=-1, keepdim=True)
    part = torch.einsum("bjhrqk,bjkhd->bjhrqd", ex, vf)
    w = torch.exp(mx - torch.amax(mx, dim=1, keepdim=True))       # the one rescale
    out = torch.sum(part * w, dim=1) / torch.sum(den * w, dim=1)  # (B, Hkv, rep, Tq, Dv)
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, hq, v.shape[-1]).to(q.dtype)


def _decode_mla(params, x: torch.Tensor, cache: MLACache, cfg: ModelConfig):
    """The reference's absorbed MLA decode: the new row is written at
    ``min(pos, S - 1)``; q_nope is absorbed through ``w_uk`` into the
    compressed space, where it scores ``c_kv`` in fp32 beside the rotary
    part, the probabilities average ``c_kv``, and the result (cast back to
    x's type) goes out through ``w_uv`` and ``w_o``.  Advances ``lengths``
    in place."""
    b = x.shape[0]
    pos = cache.lengths.long()                     # (B,) per-slot positions
    positions = pos[:, None]
    q_nope, q_pe = _mla_q(params, x, positions, cfg)
    c_new, kpe_new = _mla_kv(params, x, positions, cfg)
    s = cache.c_kv.shape[1]
    slot = torch.clamp(pos, max=s - 1)
    bidx = torch.arange(b, device=x.device)
    for buf, new in ((cache.c_kv, c_new), (cache.k_pe, kpe_new)):
        buf.index_put_((bidx, slot), new[:, 0].to(buf.dtype))
    # absorption: q_abs[h] = q_nope[h] @ w_uk[h]^T, in the compressed space
    q_abs = torch.einsum("bthe,rhe->bthr", q_nope, params["w_uk"])     # (B, 1, H, rank)
    acc = torch.promote_types(x.dtype, torch.float32)
    c_kv = cache.c_kv.to(acc)
    logits = (torch.einsum("bthr,bsr->bths", q_abs.to(acc), c_kv)
              + torch.einsum("bthe,bse->bths", q_pe.to(acc), cache.k_pe.to(acc))) * _mla_scale(cfg)
    kpos = torch.arange(s, device=x.device)
    mask = kpos[None, None, None, :] <= pos[:, None, None, None]
    probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    out_c = torch.einsum("bths,bsr->bthr", probs, c_kv)                  # compressed out
    out = torch.einsum("bthr,rhe->bthe", out_c.to(x.dtype), params["w_uv"])
    cache.lengths.add_(1)
    return torch.einsum("bthe,hed->btd", out, params["w_o"]), cache
