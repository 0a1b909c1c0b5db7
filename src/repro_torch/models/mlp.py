"""MLPs and Mixture-of-Experts (``repro/models/mlp.py``).

MoE dispatch is the reference's scatter/gather: per-token top-k routing on
fp32 router logits, each (token, k) assignment's position in its expert's
queue by an exclusive cumsum over the flattened (token, k) order, capacity
dropping, an index inverse (slot -> token row) through which the rows are
gathered into an (E, cap, D) buffer, the expert FFNs as batched matmuls,
and a weighted scatter-add back into the token rows.  The expert matmuls
are XLA einsums in the reference, not a Pallas kernel, so here they are
``torch.bmm``.

The group and expert-shard dimensions of the reference's dispatch buffer
(``(groups, expert_shards, e_local * cap + 1, D)``) are kept, and both
counts are read from the active virtual mesh (``parallel/api.py``), as the
reference reads its mesh: under one, each group dispatches its own tokens
at its own capacity; without one both counts are 1.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import ACT, dense_init
from repro_torch.parallel.api import _ACTIVE, axis_size

# a dispatch of at most this many (token, k) assignments takes capacity n
# (dropless): decode and small batches never drop (``repro/models/mlp.py``)
DROPLESS_ASSIGNMENTS = 512


# ---------------------------------------------------------------------------
# Dense (gated) MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype, gated: bool = True,
             bias: bool = False) -> dict:
    p = {
        "w_up": dense_init(gen, (d_model, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, fan_in=d_ff),
    }
    if gated:
        p["w_gate"] = dense_init(gen, (d_model, d_ff), dtype)
    if bias:
        p["b_up"] = torch.zeros((d_ff,), dtype=dtype, device=gen.device)
        p["b_down"] = torch.zeros((d_model,), dtype=dtype, device=gen.device)
    return p


def mlp(params: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    up = x @ params["w_up"]
    if "b_up" in params:
        up = up + params["b_up"]
    if "w_gate" in params:
        h = ACT[act](x @ params["w_gate"]) * up
    else:
        h = ACT[act](up)
    y = h @ params["w_down"]
    if "b_down" in params:
        y = y + params["b_down"]
    return y


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------


def init_moe(gen: torch.Generator, cfg, dtype) -> dict:
    """The router is drawn in fp32 whatever ``dtype`` is, as the reference's."""
    m = cfg.moe
    d, e = cfg.d_model, m.n_experts
    p = {
        "router": dense_init(gen, (d, e), torch.float32),
        "w_gate": dense_init(gen, (e, d, m.d_ff_expert), dtype),
        "w_up": dense_init(gen, (e, d, m.d_ff_expert), dtype),
        "w_down": dense_init(gen, (e, m.d_ff_expert, d), dtype, fan_in=m.d_ff_expert),
    }
    if m.n_shared_experts:
        p["shared"] = init_mlp(gen, d, m.d_ff_shared, dtype, gated=True)
    return p


def _top_k(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last dim, in descending order,
    the lower index first among equal values (a stable sort keeps it so,
    where ``torch.topk`` does not promise an order for ties)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router_w: torch.Tensor, x_flat: torch.Tensor, m):
    """(..., D) -> top-k (weights, expert ids), softmax over all experts,
    the selected weights renormalised; fp32 logits (fp64 stays fp64)."""
    acc = torch.promote_types(x_flat.dtype, torch.float32)
    logits = x_flat.to(acc) @ router_w.to(acc)                # (..., E)
    gates = torch.softmax(logits, dim=-1)
    topw, topi = _top_k(gates, m.top_k)                      # (..., k)
    topw = topw / torch.sum(topw, dim=-1, keepdim=True)
    return topw, topi, gates


def _dispatch_groups(batch: int) -> int:
    """Token groups for shard-local dispatch: one per data shard of the
    active mesh's ``moe_groups`` axes, ``gcd(dp, batch)``, as the
    reference's; one without a mesh.  Capacity, queue positions and drops
    are per group."""
    return math.gcd(axis_size(_ACTIVE.rules.get("moe_groups")), batch)


def _expert_shards() -> int:
    """Shards of the active mesh's ``experts`` axis; one without a mesh."""
    return axis_size(_ACTIVE.rules.get("experts"))


def moe_capacity(n: int, m) -> int:
    """Slots per expert for a dispatch of ``n`` tokens: ``n * k * cf / E``,
    raised to ``n`` (dropless) at ``DROPLESS_ASSIGNMENTS`` assignments or
    fewer, so decode never drops what the forward keeps."""
    cap = max(1, int(n * m.top_k * m.capacity_factor) // m.n_experts)
    if n * m.top_k <= DROPLESS_ASSIGNMENTS:
        cap = max(cap, n)
    return cap


def queue_positions(topi: torch.Tensor, n_experts: int, cap: int):
    """(g, n, k) expert ids -> (each assignment's position in its expert's
    queue, whether it fits the capacity): the exclusive cumsum of the
    one-hot assignments over the flattened (token, k) order, so the same
    assignments drop as in the reference."""
    g, n, k = topi.shape
    flat = topi.reshape(g, n * k)
    onehot = torch.nn.functional.one_hot(flat, n_experts)      # (g, n*k, E)
    before = torch.cumsum(onehot, dim=1) - onehot              # exclusive cumsum
    pos = torch.gather(before, 2, flat[..., None])[..., 0].reshape(g, n, k)
    return pos, pos < cap


def moe(params: dict, x: torch.Tensor, cfg, act: str = "silu") -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D), the reference's dispatch (module
    docstring).

    Every slot of the index inverse defaults to the zero pad row ``n``, and
    every dropped assignment writes the one overflow slot ``e_local * cap``.
    Those writes repeat an index, and an ``index_put_`` with repeated
    indices keeps an arbitrary one of them (on a card the winner may change
    between the forward and a remat's recompute).  That is harmless only
    because the dispatch reads the first ``e_local * cap`` slots alone, and
    the combine reads the appended zero row at the overflow slot with weight
    0 (a dropped assignment's weight is ``topw * keep``): it adds +0.  Keep
    both zero.
    """
    m = cfg.moe
    b, t, d = x.shape
    e, k = m.n_experts, m.top_k
    gcount = _dispatch_groups(b)
    ep = _expert_shards()
    if e % ep:
        ep = 1
    e_loc = e // ep
    n = (b * t) // gcount
    xf = x.reshape(gcount, n, d)
    topw, topi, _ = _route(params["router"], xf, m)          # (g, n, k)
    cap = moe_capacity(n, m)
    pos, keep = queue_positions(topi, e, cap)
    dest = (topi // e_loc).reshape(gcount, n * k)            # expert shard
    lslot = torch.where(keep, (topi % e_loc) * cap + pos, e_loc * cap).reshape(gcount, n * k)

    # dispatch: the index inverse (slot -> token row, n = the zero pad row),
    # then a gather of the rows through it
    dev = x.device
    gi = torch.arange(gcount, device=dev)[:, None].expand(gcount, n * k)
    tok = torch.arange(n, device=dev).repeat_interleave(k).expand(gcount, n * k)
    inv = torch.full((gcount, ep, e_loc * cap + 1), n, dtype=torch.long, device=dev)
    inv.index_put_((gi, dest, lslot), tok)
    xf_pad = torch.cat([xf, xf.new_zeros((gcount, 1, d))], dim=1)
    g3 = torch.arange(gcount, device=dev)[:, None, None]
    xe = xf_pad[g3, inv[..., :e_loc * cap]]                  # (g, EP, e_loc*cap, D)

    # the expert FFNs: one batched matmul over the (shard, local expert) pairs
    xe = xe.reshape(gcount, e, cap, d).transpose(0, 1).reshape(e, gcount * cap, d)
    gate = torch.bmm(xe, params["w_gate"])
    up = torch.bmm(xe, params["w_up"])
    ye = torch.bmm(ACT[act](gate) * up, params["w_down"])    # (E, g*cap, D)
    ye = ye.reshape(e, gcount, cap, d).transpose(0, 1).reshape(gcount, ep, e_loc * cap, d)

    # combine: each token's k slot outputs times their weights, added into
    # its row in slot order, the order in which the reference's scatter-add
    # (and an index_add on the CPU) visits them.  A gather and k adds in a
    # fixed order, not an index_add: on a card an index_add adds a row's k
    # contributions by atomics, in any order, and at top-8 another order
    # gives other bits, so a decode row would not be computed on its own.
    # A dropped assignment reads the zero row at the overflow slot, the
    # last in slot order, with weight 0: it adds +0.
    w = (topw * keep.to(topw.dtype)).to(x.dtype)             # (g, n, k)
    ye_flat = torch.cat([ye, ye.new_zeros((gcount, ep, 1, d))], dim=2)
    dest3, slot3 = dest.reshape(gcount, n, k), lslot.reshape(gcount, n, k)
    order = torch.argsort(dest3 * (e_loc * cap + 1) + slot3, dim=-1)
    picked = ye_flat[g3, torch.gather(dest3, 2, order), torch.gather(slot3, 2, order)]
    picked = picked * torch.gather(w, 2, order)[..., None]
    y = x.new_zeros((gcount, n, d))
    for j in range(k):
        y = y + picked[:, :, j]
    if "shared" in params:
        y = y + mlp(params["shared"], x, act).reshape(gcount, n, d)
    return y.reshape(b, t, d)


def moe_aux_loss(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style f*P).  As in the
    reference, ``lm_loss`` does not add it."""
    m = cfg.moe
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    acc = torch.promote_types(xf.dtype, torch.float32)
    gates = torch.softmax(xf.to(acc) @ params["router"].to(acc), dim=-1)
    _, topi = _top_k(gates, m.top_k)
    frac = torch.mean(torch.nn.functional.one_hot(topi, m.n_experts).to(acc), dim=(0, 1))
    prob = torch.mean(gates, dim=0)
    return m.n_experts * torch.sum(frac * prob)
