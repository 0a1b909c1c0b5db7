"""Decoder-only LM: ``repro/models/lm.py``.

Layers are grouped into *segments* as in the reference (an irregular prefix
plus a periodic block repeated R times), and the params keep its layout:
``params["segments"][s]`` is a list over the block's layers of dicts whose
leaves are stacked over the R repeats, so a JAX param tree converts leaf for
leaf (``interop.lm_params_from_jax``); a config with ``mtp_depth`` > 0
(DeepSeek-V3) also holds the reference's ``params["mtp"]``: ``proj``,
``norm`` and one unstacked layer of the last layer's kind.  Where the
reference runs ``lax.scan`` over the repeats, the port runs a Python loop over
``unbind(0)`` views of the stacked leaves (the backward stacks the layers'
gradients once).  ``remat="full"`` wraps each block in a non-reentrant
``torch.utils.checkpoint``, as ``jax.checkpoint`` does; ``remat="dots"``
checkpoints it selectively (``save_dots``): the outputs of matmuls with no
batch dimension are saved and the rest recomputed, as the reference's
``checkpoint_dots_with_no_batch_dims``, but for the projections whose
outputs only add into the block's output, which no backward reads and
the reference's partial evaluation drops (``_block_output_weights``).  The reference's ``constrain`` /
``gather_for_compute`` are identities on one device (``parallel/api.py``)
and are not called.

Sequence parallelism: ``apply_lm(seq_axis=)`` runs the Mamba2 mixers
sequence-sharded over an axis of the active virtual mesh
(``models/mamba2.py``); dense MLPs and norms act per token.  A model with
an attention or MoE layer is refused (ROADMAP C.17): the reference's
sharded ``apply_lm`` attends within each shard at positions that restart at
0, and dispatches each shard's tokens at the shard's own capacity.

Losses: token-chunked cross-entropy (each chunk checkpointed, so peak
memory is chunk x vocab, not tokens x vocab).  A layer's mixer is attention
(``models/attention.py``: GQA, or MLA where the config has one) or a Mamba2
block (``models/mamba2.py``); its feed-forward a dense MLP or, on an MoE
layer, the experts (``models/mlp.py:moe``).  As in the reference,
``lm_loss`` adds no router aux loss (``aux_weight`` changes nothing), and
where ``params`` hold ``mtp`` it adds 0.3 x the MTP head's CE
(``mtp_loss``).  A VLM (Qwen2-VL) takes ``extra_embeds``, its patch
embeddings, in place of the leading token embeddings, and M-RoPE's ``(3, B,
T)`` position streams (three ``arange`` streams by default); its attention
masks by the sequence index (``models/attention.py``, ROADMAP C.14).

Serving: ``init_caches`` (one ``KVCache``, ``MLACache`` or ``MambaState``
per layer, preallocated), ``decode_step`` (one token per slot in, fp32
logits out, the caches written in place; ``seq_sharded_cache`` takes the
flash-decode form of ``decode_attention``) and ``prefill``, which, as the reference's, runs
the full forward for the last position's logits and hands back the caches
it was given untouched (no engine calls it: ROADMAP C).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import KVCache, MLACache
from repro_torch.models.common import apply_norm, draws_into, embed_init, init_norm
from repro_torch.models.mamba2 import MambaState
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.parallel.api import captured_ctx


# ---------------------------------------------------------------------------
# Layer kinds and segment planning
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str          # "attn" | "mamba"
    moe: bool
    swa: bool           # sliding-window on this attention layer


@dataclasses.dataclass(frozen=True)
class Segment:
    start: int
    block: tuple[LayerKind, ...]
    repeats: int


def layer_kind(cfg: ModelConfig, i: int) -> LayerKind:
    mixer = "attn" if cfg.is_attn_layer(i) else "mamba"
    return LayerKind(
        mixer=mixer,
        moe=cfg.is_moe_layer(i),
        swa=(cfg.swa_window is not None and mixer == "attn"),
    )


def _smallest_period(kinds: list[LayerKind]) -> int:
    for p in range(1, len(kinds) + 1):
        if len(kinds) % p == 0 and all(kinds[i] == kinds[i % p] for i in range(len(kinds))):
            return p
    return len(kinds)


def plan_segments(cfg: ModelConfig) -> list[Segment]:
    """Split layers into (irregular prefix, periodic tail) minimising the
    total block size, as the reference does (dense LMs: one segment of L
    repeats of a one-layer block)."""
    kinds = [layer_kind(cfg, i) for i in range(cfg.n_layers)]
    best = None
    for prefix in range(0, min(8, cfg.n_layers)):
        tail = kinds[prefix:]
        p = _smallest_period(tail) if tail else 0
        score = prefix + p
        if best is None or score < best[0]:
            best = (score, prefix, p)
    _, prefix, period = best
    segs: list[Segment] = []
    if prefix:
        segs.append(Segment(0, tuple(kinds[:prefix]), 1))
    tail = kinds[prefix:]
    if tail:
        segs.append(Segment(prefix, tuple(tail[:period]), len(tail) // period))
    return segs


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_layer(gen: torch.Generator, kind: LayerKind, cfg: ModelConfig, dtype) -> dict:
    p: dict[str, Any] = {"norm1": init_norm(cfg.norm, cfg.d_model, dtype, gen.device)}
    if kind.mixer == "attn":
        p["attn"] = attn_mod.init_attention(gen, cfg, dtype)
    else:
        p["mamba"] = mamba_mod.init_mamba(gen, cfg, dtype)
    has_ffn = cfg.d_ff > 0 or kind.moe
    if has_ffn and not cfg.parallel_block:
        p["norm2"] = init_norm(cfg.norm, cfg.d_model, dtype, gen.device)
    if kind.moe:
        p["moe"] = mlp_mod.init_moe(gen, cfg, dtype)
    elif cfg.d_ff > 0:
        p["mlp"] = mlp_mod.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                    gated=(cfg.act == "silu"), bias=cfg.mlp_bias)
    return p


class _Rows:
    """The sink of a segment's draws (``models/common.py:draws_into``): at
    repeat 0 each draw allocates its stacked leaf, in draw order, and lands
    in row 0; at repeat r the draw of the same order lands in row r.  So a
    drawn leaf is never held twice, and init's peak is the params plus one
    fp32 draw."""

    def __init__(self, repeats: int):
        self.repeats = repeats
        self.leaves: list[torch.Tensor] = []
        self.r = self.i = 0

    def start(self, r: int) -> None:
        self.r, self.i = r, 0

    def __call__(self, w: torch.Tensor, dtype) -> torch.Tensor:
        if self.r == 0:
            self.leaves.append(w.new_empty((self.repeats, *w.shape), dtype=dtype))
        row = self.leaves[self.i][self.r]
        self.i += 1
        return row.copy_(w)

    def drawn(self, a: torch.Tensor) -> bool:
        """Whether ``a`` is a row this sink handed out."""
        return any(a._base is leaf for leaf in self.leaves)


def stacked_draws(repeats: int, draw):
    """``draw()`` (one layer's tree, or a block's list of them) run
    ``repeats`` times into one tree of stacked leaves, each allocated once
    at its final dtype: a drawn leaf at its first draw, when each draw is
    cast into its row (``_Rows``), the rest (norms, biases: zeros and ones)
    after the first repeat, and copied into their rows."""
    rows, stacked = _Rows(repeats), None
    for r in range(repeats):
        rows.start(r)
        with draws_into(rows):
            block = draw()
        if stacked is None:
            stacked = tree_map(lambda a: a._base if rows.drawn(a) else
                               a.new_empty((repeats, *a.shape)), block)
        for dst, src in zip(tree_leaves(stacked), tree_leaves(block)):
            if not rows.drawn(src):
                dst[r].copy_(src)
        del block
    return stacked


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Params on ``gen.device``, drawn from ``gen`` in a fixed order: the
    embedding, the head, then each segment's layers repeat by repeat into
    their stacked leaves (``stacked_draws``).  So the embedding's fp32 draw
    never meets the layers, and init holds the params plus one fp32 draw at
    most (an MoE layer's experts are one draw each).  The MTP head, where
    the config has one, is drawn last, as the reference's: ``proj``,
    ``norm`` and one layer of the last layer's kind, unstacked, each draw
    cast on its own."""
    dtype = cfg.p_dtype
    params: dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), dtype),
        "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, (cfg.vocab, cfg.d_model), dtype)
    params["segments"] = [
        stacked_draws(seg.repeats,
                      lambda seg=seg: [_init_layer(gen, kind, cfg, dtype) for kind in seg.block])
        for seg in plan_segments(cfg)]
    if cfg.mtp_depth > 0:
        params["mtp"] = {
            "proj": embed_init(gen, (2 * cfg.d_model, cfg.d_model), dtype),
            "norm": init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
            "layer": _init_layer(gen, layer_kind(cfg, cfg.n_layers - 1), cfg, dtype),
        }
    return params


def abstract_params(cfg: ModelConfig) -> dict:
    """The params' shapes and dtypes as ``meta`` tensors, drawing and
    allocating nothing (the reference's ``jax.eval_shape`` of ``init_lm``,
    for the dry run): ``init_lm`` traced under ``FakeTensorMode``
    (``train/trainer.py:abstract_of``)."""
    from repro_torch.train.trainer import abstract_of

    return abstract_of(lambda seed: init_lm(torch.Generator().manual_seed(seed), cfg))[0]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _apply_layer(p: dict, kind: LayerKind, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, *, arange_positions: bool = False,
                 seq_axis: Optional[str] = None) -> torch.Tensor:
    h = apply_norm(cfg.norm, x, p["norm1"])
    if kind.mixer == "attn":
        window = cfg.swa_window if kind.swa else None
        mix = attn_mod.attention(p["attn"], h, positions, cfg, causal=True, window=window,
                                 arange_positions=arange_positions)
    else:
        mix = mamba_mod.mamba_block(p["mamba"], h, cfg, seq_axis=seq_axis)
    if cfg.parallel_block:
        # command-r: attn and mlp both read the same normed input
        ff = mlp_mod.mlp(p["mlp"], h, cfg.act) if "mlp" in p else 0.0
        return x + mix + ff
    x = x + mix
    if "moe" in p:
        h2 = apply_norm(cfg.norm, x, p["norm2"])
        x = x + mlp_mod.moe(p["moe"], h2, cfg, cfg.act)
    elif "mlp" in p:
        h2 = apply_norm(cfg.norm, x, p["norm2"])
        x = x + mlp_mod.mlp(p["mlp"], h2, cfg.act)
    return x


def _unbind(tree, n: int) -> list:
    """A tree of (n, ...) leaves -> n trees of views ``leaf[r]``."""
    parts = tree_map(lambda a: a.unbind(0), tree)      # leaves become n-tuples
    return [tree_map(lambda t, r=r: t[r], parts) for r in range(n)]


_aten = torch.ops.aten


def save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat="dots"``'s selective-checkpoint policy, the counterpart of
    ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``: save
    the output of every matmul with no batch dimension, recompute the rest.
    ``x @ w`` and ``F.linear`` reach the dispatcher as ``mm`` / ``addmm``;
    an einsum whose contraction has no batch dimension (MLA's
    ``"btr,rhe->bthe"``) as a ``bmm`` over a batch of 1.  A ``bmm`` over a
    real batch (attention's scores and values, the experts' FFNs) is
    recomputed.  Kernel launches (B4, B5, B6) are invisible here: their
    buffers are recomputed, so the recomputation launches them again."""
    if op in (_aten.mm.default, _aten.addmm.default) or (
            op is _aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _block_output_weights(block: tuple, block_p: list, cfg: ModelConfig) -> frozenset:
    """The data pointers of the weights whose matmul outputs only add into
    the block's output: the last layer's ``w_down`` (its shared expert's on
    an MoE layer), or its mixer's output projection where no feed-forward
    follows, both under a parallel block.  No backward reads these
    outputs, so the reference's partial evaluation saves none of them."""
    p, kind = block_p[-1], block[-1]
    mix = p["attn"]["w_o"] if kind.mixer == "attn" else p["mamba"]["w_out"]
    ff = (p["moe"].get("shared", {}).get("w_down") if "moe" in p
          else p["mlp"]["w_down"] if "mlp" in p else None)
    if cfg.parallel_block:
        ws = [mix, ff]
    else:
        ws = [ff] if ("moe" in p or "mlp" in p) else [mix]
    return frozenset(w.data_ptr() for w in ws if w is not None)


def _dots_context(unsaved: frozenset = frozenset()):
    """``save_dots``, save where a matmul reads a weight of ``unsaved``
    (``_block_output_weights``): those outputs are recomputed."""
    def policy(ctx, op, *args, **kwargs):
        if any(isinstance(a, torch.Tensor) and a.data_ptr() in unsaved for a in args):
            return CheckpointPolicy.PREFER_RECOMPUTE
        return save_dots(ctx, op, *args, **kwargs)

    return create_selective_checkpoint_contexts(policy)


def _refuse_c17(cfg: ModelConfig) -> None:
    """The sequence-sharded forward runs Mamba2 mixers, dense MLPs and
    norms; attention and MoE layers are refused (ROADMAP C.17)."""
    for i in range(cfg.n_layers):
        kind = layer_kind(cfg, i)
        if kind.mixer == "attn":
            raise ValueError(
                f"seq_axis: layer {i} is attention, which the reference's sequence-sharded "
                "apply_lm runs within each shard at positions restarting at 0 (ROADMAP C.17); "
                "only Mamba2 mixers run sequence-sharded")
        if kind.moe:
            raise ValueError(
                f"seq_axis: layer {i} is MoE, which the reference's sequence-sharded "
                "apply_lm dispatches per shard at the shard's capacity, dropping other "
                "assignments than its unsharded run (ROADMAP C.17)")


def apply_lm(
    params: dict,
    tokens: torch.Tensor,                 # (B, T) int
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    extra_embeds: Optional[torch.Tensor] = None,
    remat: str = "none",
    seq_axis: Optional[str] = None,
    unroll: bool = False,
) -> torch.Tensor:
    """Token ids -> final hidden states (B, T, D).  ``extra_embeds`` (B, Tv,
    D), a VLM's patch embeddings (the vision frontend is a stub, as in the
    reference), replace the leading Tv token embeddings.  ``seq_axis`` runs
    the Mamba2 mixers sequence-sharded over that axis of the active virtual
    mesh (models with attention or MoE layers are refused: ``_refuse_c17``).
    ``unroll`` (the reference's analysis mode) changes nothing here: the
    layers are always a Python loop."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat={remat!r}: one of 'none', 'full', 'dots'")
    if seq_axis is not None:
        _refuse_c17(cfg)
    x = F.embedding(tokens.long(), params["embed"]).to(cfg.act_dtype)
    if extra_embeds is not None:
        tv = extra_embeds.shape[1]
        x = torch.cat([extra_embeds.to(cfg.act_dtype), x[:, tv:]], dim=1)
    arange_positions = positions is None
    if arange_positions:
        b, t = tokens.shape
        positions = torch.arange(t, device=x.device)[None].expand(b, t)
        if cfg.mrope_sections is not None:
            positions = positions.expand(3, b, t)

    # a checkpoint's recomputation runs in the backward, on autograd's thread
    # for a card: it re-enters the mesh and attention mode this forward ran under
    enter, enter_attn = captured_ctx(), attn_mod.captured_impl()
    for seg, seg_p in zip(plan_segments(cfg), params["segments"]):
        def block_fn(x, block_p, seg=seg):
            with enter(), enter_attn():
                for j, kind in enumerate(seg.block):
                    x = _apply_layer(block_p[j], kind, x, positions, cfg,
                                     arange_positions=arange_positions, seq_axis=seq_axis)
            return x

        for block_p in _unbind(seg_p, seg.repeats):
            # no block draws random numbers, so the recomputation needs no
            # saved RNG state (and a captured step could not save the card's)
            if remat == "full":
                x = checkpoint(block_fn, x, block_p, use_reentrant=False,
                               preserve_rng_state=False)
            elif remat == "dots":
                unsaved = _block_output_weights(seg.block, block_p, cfg)
                x = checkpoint(block_fn, x, block_p, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=partial(_dots_context, unsaved))
            else:
                x = block_fn(x, block_p)
    return apply_norm(cfg.norm, x, params["final_norm"])


def lm_head_weight(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def _ce_chunk(hs, ys, head_w, acc_dtype):
    logits = (hs @ head_w.T).to(acc_dtype)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, 1, torch.clamp(ys, min=0)[:, None])[:, 0]
    valid = (ys >= 0).to(acc_dtype)
    return torch.sum((lse - ll) * valid), torch.sum(valid)


def chunked_cross_entropy(
    hidden: torch.Tensor,     # (B, T, D)
    head_w: torch.Tensor,     # (V, D)
    labels: torch.Tensor,     # (B, T) int; -100 = ignore
    *,
    chunk: int = 512,
    unroll: bool = False,     # analysis mode: single full-width chunk
) -> torch.Tensor:
    """Mean CE, streamed over token chunks: logits in the activation type,
    then fp32 (fp64 stays fp64); the padded tail carries label -100."""
    b, t, d = hidden.shape
    n = b * t
    h = hidden.reshape(n, d)
    y = labels.reshape(n).long()
    chunk = n if unroll else min(chunk, n)
    pad = (-n) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        y = F.pad(y, (0, pad), value=-100)
    acc = torch.promote_types(hidden.dtype, torch.float32)
    loss_sum = torch.zeros((), dtype=acc, device=hidden.device)
    cnt = torch.zeros((), dtype=acc, device=hidden.device)
    for i in range(h.shape[0] // chunk):
        s = slice(i * chunk, (i + 1) * chunk)
        ls, c = checkpoint(_ce_chunk, h[s], y[s], head_w, acc, use_reentrant=False,
                           preserve_rng_state=False)      # draws nothing
        loss_sum = loss_sum + ls
        cnt = cnt + c
    return loss_sum / torch.clamp(cnt, min=1.0)


MTP_WEIGHT = 0.3


def lm_loss(
    params: dict,
    batch: dict,
    cfg: ModelConfig,
    *,
    remat: str = "full",
    aux_weight: float = 0.01,
    unroll: bool = False,
    ce_chunk: int = 512,
) -> torch.Tensor:
    """batch: {"tokens": (B,T), "labels": (B,T), ["positions"]}.  No router
    aux loss is added (the reference's ``lm_loss`` adds none either), so
    ``aux_weight`` changes nothing.  Where ``params`` hold ``mtp``,
    ``MTP_WEIGHT`` x ``mtp_loss`` is added."""
    hidden = apply_lm(
        params, batch["tokens"], cfg,
        positions=batch.get("positions"),
        extra_embeds=batch.get("patch_embeds"),
        remat=remat,
        unroll=unroll,
    )
    head = lm_head_weight(params, cfg).to(cfg.act_dtype)
    loss = chunked_cross_entropy(hidden, head, batch["labels"], chunk=ce_chunk, unroll=unroll)
    if cfg.mtp_depth > 0 and "mtp" in params:
        loss = loss + MTP_WEIGHT * mtp_loss(params, batch, hidden, head, cfg, unroll=unroll)
    return loss


def mtp_loss(params: dict, batch: dict, hidden: torch.Tensor, head: torch.Tensor,
             cfg: ModelConfig, *, unroll: bool = False) -> torch.Tensor:
    """The MTP head's mean CE, as the reference's: token t's final hidden
    state beside the embedding of token t + 1 (the tokens rolled left, so
    the last position sees token 0), through ``proj``, ``norm`` and the MTP
    layer at positions ``arange(T)`` with no remat, scored by the shared
    head against the labels rolled left with the last one ignored, at the
    default CE chunk.  ``unroll`` (the dry run's analysis mode) merges the
    chunks into one, as it does the main CE's: the same FLOPs in a trace of
    fewer ops."""
    mtp = params["mtp"]
    tokens = batch["tokens"]
    emb_next = F.embedding(torch.roll(tokens, -1, dims=1).long(), params["embed"])
    h2 = torch.cat([hidden, emb_next.to(hidden.dtype)], dim=-1) @ mtp["proj"]
    h2 = apply_norm(cfg.norm, h2, mtp["norm"])
    b, t = tokens.shape
    pos = torch.arange(t, device=h2.device)[None].expand(b, t)
    h2 = _apply_layer(mtp["layer"], layer_kind(cfg, cfg.n_layers - 1), h2, pos, cfg,
                      arange_positions=True)
    labels = torch.roll(batch["labels"], -1, dims=1)
    labels[:, -1] = -100
    return chunked_cross_entropy(h2, head, labels, unroll=unroll)


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with per-layer caches
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, dtype, device="cpu") -> list:
    """One cache entry per layer, zeroed, on ``device`` (``"meta"``
    allocates nothing): an MLA layer's compressed cache and a full-attention
    layer's KV cache have ``max_seq`` rows, a sliding-window layer's
    ``min(max_seq, swa_window)``."""
    caches = []
    for i in range(cfg.n_layers):
        kind = layer_kind(cfg, i)
        if kind.mixer == "mamba":
            caches.append(MambaState.init(batch, cfg, dtype, device))
        elif cfg.mla is not None:
            m = cfg.mla
            caches.append(MLACache.init(batch, max_seq, m.kv_lora_rank, m.qk_rope_head_dim,
                                        dtype, device))
        else:
            s = min(max_seq, cfg.swa_window) if kind.swa else max_seq
            caches.append(KVCache.init(batch, s, cfg.n_kv_heads, cfg.resolved_head_dim, dtype,
                                       device))
    return caches


def _decode_layer(p, kind: LayerKind, x, cache, cfg: ModelConfig, seq_sharded: bool):
    """One layer of ``decode_step``; ``cache`` is written in place."""
    h = apply_norm(cfg.norm, x, p["norm1"])
    if kind.mixer == "attn":
        window = cfg.swa_window if kind.swa else None
        mix, _ = attn_mod.decode_attention(
            p["attn"], h, cache, cfg, window=window, seq_sharded=seq_sharded)
    else:
        mix, _ = mamba_mod.mamba_decode(p["mamba"], h, cache, cfg)
    if cfg.parallel_block:
        ff = mlp_mod.mlp(p["mlp"], h, cfg.act) if "mlp" in p else 0.0
        return x + mix + ff
    x = x + mix
    if "moe" in p:
        x = x + mlp_mod.moe(p["moe"], apply_norm(cfg.norm, x, p["norm2"]), cfg, cfg.act)
    elif "mlp" in p:
        x = x + mlp_mod.mlp(p["mlp"], apply_norm(cfg.norm, x, p["norm2"]), cfg.act)
    return x


def decode_step(
    params: dict,
    token: torch.Tensor,          # (B, 1) int
    caches: list,
    cfg: ModelConfig,
    *,
    seq_sharded_cache: bool = False,
) -> tuple[torch.Tensor, list]:
    """One token in, next-token logits (B, 1, V) in fp32 out.  A Python loop
    over the layers keeps the caches per layer; each is written in place,
    and the list comes back as given."""
    x = F.embedding(token.long(), params["embed"]).to(cfg.act_dtype)
    li = 0
    for seg, seg_p in zip(plan_segments(cfg), params["segments"]):
        for block_p in _unbind(seg_p, seg.repeats):
            for j, kind in enumerate(seg.block):
                x = _decode_layer(block_p[j], kind, x, caches[li], cfg, seq_sharded_cache)
                li += 1
    x = apply_norm(cfg.norm, x, params["final_norm"])
    logits = (x @ lm_head_weight(params, cfg).to(cfg.act_dtype).T).float()
    return logits, caches


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            caches: list) -> tuple[torch.Tensor, list]:
    """The reference's prefill: the full forward (B4 or B5, and B6) for the
    last position's fp32 logits (B, 1, V).  Like the reference's, it writes
    nothing into ``caches`` and returns them as given."""
    hidden = apply_lm(params, tokens, cfg)
    logits = (hidden[:, -1:] @ lm_head_weight(params, cfg).to(cfg.act_dtype).T).float()
    return logits, caches
