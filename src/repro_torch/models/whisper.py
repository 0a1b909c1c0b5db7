"""Whisper-style encoder-decoder backbone (``repro/models/whisper.py``;
arXiv:2212.04356).

The conv/mel frontend is a stub, as in the reference: the input specs supply
precomputed frame embeddings (B, T_enc, D) to the encoder.  The transformer
backbone (24 encoder and 24 decoder layers for whisper-medium) is real:
bidirectional encoder self-attention, causal decoder self-attention and
cross-attention, GELU MLPs with biases, pre-LayerNorm.  Every attention of
the training path runs the flash-attention op (B4): the encoder's
non-causal, the decoder's causal at ``arange`` positions, and the
cross-attention, non-causal with the encoder's keys
(``models/attention.py:attention``).

Params keep the reference's layout: ``enc`` and ``dec`` hold each layer
leaf stacked over the layers, drawn into their rows as ``init_lm`` draws a
segment (``models/lm.py:stacked_draws``); ``dec_pos`` is a learned table of
``DEC_POS_ROWS`` rows.  ``remat`` other than ``"none"`` checkpoints each
layer's whole body, ``"dots"`` included, as the reference's
``jax.checkpoint(body)`` does.

Serving: one ``WhisperCache`` per decoder layer (the self-attention
``KVCache`` and the cross K/V), ``whisper_decode_step`` one token per slot.
As in the reference, ``init_whisper_caches`` zeroes the cross K/V and the
serving path never writes them (ROADMAP C.15: no request carries audio), so
a caller that decodes against an encoding fills them itself, from
``cross_attention_kv(encode(frames))``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.common import apply_norm, embed_init, init_norm
from repro_torch.models.lm import _unbind, chunked_cross_entropy, stacked_draws
from repro_torch.optim.optimizers import tree_leaves

# the rows of the decoder's learned position table: the reference draws
# 8192, whatever the config's ``max_pos`` (ROADMAP C.16)
DEC_POS_ROWS = 8192


def _sinusoid(t: int, d: int, dtype, device) -> torch.Tensor:
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    # the base as a Python number: a tensor made from it on the card is a
    # host copy, which a captured step may not hold
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _init_enc_layer(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    dev = gen.device
    return {
        "norm1": init_norm(cfg.norm, cfg.d_model, dtype, dev),
        "attn": attn_mod.init_attention(gen, cfg, dtype),
        "norm2": init_norm(cfg.norm, cfg.d_model, dtype, dev),
        "mlp": mlp_mod.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, gated=False, bias=True),
    }


def _init_dec_layer(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    dev = gen.device
    return {
        "norm1": init_norm(cfg.norm, cfg.d_model, dtype, dev),
        "attn": attn_mod.init_attention(gen, cfg, dtype),
        "norm_x": init_norm(cfg.norm, cfg.d_model, dtype, dev),
        "xattn": attn_mod.init_attention(gen, cfg, dtype),
        "norm2": init_norm(cfg.norm, cfg.d_model, dtype, dev),
        "mlp": mlp_mod.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, gated=False, bias=True),
    }


def init_whisper(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Params on ``gen.device``, drawn in the reference's order of its keys:
    the encoder's layers, the decoder's, the embedding, the position
    table."""
    dtype = cfg.p_dtype
    n_enc = cfg.n_encoder_layers or cfg.n_layers
    enc = stacked_draws(n_enc, lambda: _init_enc_layer(gen, cfg, dtype))
    dec = stacked_draws(cfg.n_layers, lambda: _init_dec_layer(gen, cfg, dtype))
    return {
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), dtype),
        "enc": enc,
        "enc_norm": init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
        "dec": dec,
        "dec_norm": init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
        "dec_pos": embed_init(gen, (DEC_POS_ROWS, cfg.d_model), dtype),
    }


def _layers(stacked: dict, remat: str, body):
    """Each layer's view of ``stacked`` and ``body`` to run on it:
    checkpointed whole for any ``remat`` but ``"none"``."""
    # no layer draws random numbers: the recomputation needs no saved RNG
    # state (and a captured step could not save the card's); it re-enters the
    # attention mode of the forward (autograd's thread for a card)
    enter_attn = attn_mod.captured_impl()

    def run(x, p):
        with enter_attn():
            return body(x, p)

    fn = body if remat == "none" else (
        lambda x, p: checkpoint(run, x, p, use_reentrant=False, preserve_rng_state=False))
    return _unbind(stacked, tree_leaves(stacked)[0].shape[0]), fn


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig, *, remat: str = "none",
           unroll: bool = False) -> torch.Tensor:
    """frames: (B, T_enc, D), the stub frontend's output -> encoder states.
    ``unroll`` changes nothing: the layers are always a Python loop."""
    x = frames.to(cfg.act_dtype) + _sinusoid(frames.shape[1], cfg.d_model, cfg.act_dtype,
                                             frames.device)

    def body(x, p):
        h = apply_norm(cfg.norm, x, p["norm1"])
        x = x + attn_mod.attention(p["attn"], h, None, cfg, causal=False)
        h = apply_norm(cfg.norm, x, p["norm2"])
        return x + mlp_mod.mlp(p["mlp"], h, "gelu")

    layers, fn = _layers(params["enc"], remat, body)
    for p in layers:
        x = fn(x, p)
    return apply_norm(cfg.norm, x, params["enc_norm"])


def decode_train(params: dict, tokens: torch.Tensor, enc: torch.Tensor, cfg: ModelConfig, *,
                 remat: str = "none", unroll: bool = False) -> torch.Tensor:
    """Teacher-forced decoder: tokens (B, T_dec) against the encoder states
    ``enc`` -> final hidden states (B, T_dec, D)."""
    b, t = tokens.shape
    x = F.embedding(tokens.long(), params["embed"]).to(cfg.act_dtype)
    x = x + params["dec_pos"][:t].to(cfg.act_dtype)
    pos = torch.arange(t, device=x.device)[None].expand(b, t)

    def body(x, p):
        h = apply_norm(cfg.norm, x, p["norm1"])
        x = x + attn_mod.attention(p["attn"], h, pos, cfg, causal=True, arange_positions=True)
        h = apply_norm(cfg.norm, x, p["norm_x"])
        kv = attn_mod.cross_attention_kv(p["xattn"], enc, cfg)
        x = x + attn_mod.attention(p["xattn"], h, pos, cfg, causal=False, kv_override=kv,
                                   arange_positions=True)
        h = apply_norm(cfg.norm, x, p["norm2"])
        return x + mlp_mod.mlp(p["mlp"], h, "gelu")

    layers, fn = _layers(params["dec"], remat, body)
    for p in layers:
        x = fn(x, p)
    return apply_norm(cfg.norm, x, params["dec_norm"])


def whisper_loss(params: dict, batch: dict, cfg: ModelConfig, *, remat: str = "full",
                 unroll: bool = False, ce_chunk: int = 512) -> torch.Tensor:
    """batch: {"frames": (B, T_enc, D), "tokens": (B, T_dec), "labels": (B,
    T_dec)} -> the mean CE through the tied head."""
    enc = encode(params, batch["frames"], cfg, remat=remat, unroll=unroll)
    hidden = decode_train(params, batch["tokens"], enc, cfg, remat=remat, unroll=unroll)
    head = params["embed"].to(cfg.act_dtype)
    return chunked_cross_entropy(hidden, head, batch["labels"], chunk=ce_chunk, unroll=unroll)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


class WhisperCache(NamedTuple):
    """One decoder layer's serving state: the self-attention ``KVCache``
    and the cross K/V (B, T_enc, Hkv, Dh).  ``slot(i)`` is a batch-1 view of
    slot ``i`` whose writes land in these tensors; ``tensors()`` lists every
    tensor once."""

    attn: KVCache
    cross_k: torch.Tensor
    cross_v: torch.Tensor

    def slot(self, i: int) -> "WhisperCache":
        return WhisperCache(self.attn.slot(i), self.cross_k[i:i + 1], self.cross_v[i:i + 1])

    def tensors(self) -> list:
        return [*self.attn, self.cross_k, self.cross_v]


def init_whisper_caches(cfg: ModelConfig, batch: int, max_seq: int, enc_len: int, dtype,
                        device="cpu") -> list:
    """Per decoder layer: a zeroed self-attention ``KVCache`` of ``max_seq``
    rows and zeroed cross K/V of ``enc_len`` rows, on ``device`` (``"meta"``
    allocates nothing)."""
    dh = cfg.resolved_head_dim
    cross = (batch, enc_len, cfg.n_kv_heads, dh)
    return [WhisperCache(KVCache.init(batch, max_seq, cfg.n_kv_heads, dh, dtype, device),
                         torch.zeros(cross, dtype=dtype, device=device),
                         torch.zeros(cross, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]


def fill_cross_caches(params: dict, caches: list, enc: torch.Tensor, cfg: ModelConfig) -> None:
    """Writes each decoder layer's ``cross_attention_kv(enc)`` into its
    cache's cross K/V: what the reference's serving path never does
    (ROADMAP C.15)."""
    for p, c in zip(_unbind(params["dec"], cfg.n_layers), caches):
        k, v = attn_mod.cross_attention_kv(p["xattn"], enc, cfg)
        c.cross_k.copy_(k)
        c.cross_v.copy_(v)


def whisper_decode_step(params: dict, token: torch.Tensor, caches: list,
                        cfg: ModelConfig) -> tuple[torch.Tensor, list]:
    """One token per slot in, next-token fp32 logits (B, 1, V) out.  Each
    layer's self-attention cache is written in place (its ``lengths``
    advanced); the cross-attention reads the cached cross K/V through the
    plain ``_sdpa``, as the reference's does."""
    x = F.embedding(token.long(), params["embed"]).to(cfg.act_dtype)
    pos = caches[0].attn.lengths.long()                      # (B,) per-slot positions
    # an idle slot's position grows past the table while others serve
    # (ROADMAP C.18): its gather reads the last row, where the reference's
    # reads NaN; a request's own positions stay inside the table (C.16)
    row = torch.clamp(pos, max=params["dec_pos"].shape[0] - 1)
    x = x + F.embedding(row, params["dec_pos"])[:, None].to(cfg.act_dtype)
    for p, c in zip(_unbind(params["dec"], cfg.n_layers), caches):
        h = apply_norm(cfg.norm, x, p["norm1"])
        mix, _ = attn_mod.decode_attention(p["attn"], h, c.attn, cfg)
        x = x + mix
        h = apply_norm(cfg.norm, x, p["norm_x"])
        tq = c.attn.lengths.long()[:, None]                  # (B, 1); unused for non-causal
        q = torch.einsum("btd,dhe->bthe", h, p["xattn"]["w_q"])
        if "b_q" in p["xattn"]:
            q = q + p["xattn"]["b_q"]
        kpos = torch.arange(c.cross_k.shape[1], device=x.device)
        out = attn_mod._sdpa(q, c.cross_k, c.cross_v, tq, kpos, causal=False, window=None)
        x = x + torch.einsum("bthe,hed->btd", out, p["xattn"]["w_o"])
        h = apply_norm(cfg.norm, x, p["norm2"])
        x = x + mlp_mod.mlp(p["mlp"], h, "gelu")
    x = apply_norm(cfg.norm, x, params["dec_norm"])
    logits = (x @ params["embed"].to(cfg.act_dtype).T).float()
    return logits, caches
