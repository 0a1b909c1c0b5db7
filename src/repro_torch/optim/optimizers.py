"""Optimizers as (init, update) pairs over param trees, as
``repro/optim/optimizers.py``.

A param tree is what the tiled CNN uses: a list of per-layer dicts of
tensors (any nesting of lists and dicts of tensors works).  States
are dicts of fp32 tensors mirroring the params, under the reference's keys
(``m``, ``v``, ``t``; ``t`` an int).  Updates are out of place, as in the
reference: a step returns new params and a new state.  The arithmetic is
the reference's fp32; fp64 params (an exact reference run) keep fp64
throughout.

``inplace=True`` (``clip_by_global_norm``, ``adamw``, ``sgd``) writes the
results into the tensors it was given instead - the same arithmetic and the
same bits, with only one leaf's temporaries alive at a time (adamw: one
slice of ``INPLACE_CHUNK`` elements of a leaf).  The LM trainer
uses it, since a full-width model's fp32 moments and gradients leave no room
for a second copy; it stands where the reference's launcher donates the
state to ``jit``.  The caller must not reuse the old state.

adamw: fp32 moments.  sgd: momentum SGD (Darknet's, for the YOLO
reproduction).  adafactor belongs to the LM side (ROADMAP A.18).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, float], tuple[Any, Any]]
    # update(grads, state, params, lr) -> (new_params, new_state)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (and the same positions of
    the trees in ``rest``), keeping the structure of lists and dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    if isinstance(tree, list):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_unzip(tree, n: int) -> list:
    """A tree whose leaves are n-tuples -> n trees."""
    return [tree_map(lambda o, i=i: o[i], tree) for i in range(n)]


def _acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the update's arithmetic type: fp32, or fp64 for fp64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(_acc(x))) for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float, inplace: bool = False):
    """``inplace`` scales the fp32 (fp64) leaves where they lie; a leaf of a
    narrower type is scaled in fp32 into a new tensor either way."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)

    def clip(g):
        if inplace and g.dtype == _acc(g).dtype:
            return g.mul_(scale)
        return (_acc(g) * scale).to(g.dtype)

    return tree_map(clip, tree), norm


def _zeros_acc(params):
    return tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.promote_types(p.dtype, torch.float32), device=p.device), params)


# elements of a leaf the in-place AdamW updates at a time
INPLACE_CHUNK = 1 << 26


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, inplace: bool = False) -> Optimizer:
    def init(params):
        return {"m": _zeros_acc(params), "v": _zeros_acc(params), "t": 0}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t

        def upd(g, m, v, p):
            g = _acc(g)
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * g * g
            step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
            step = step + weight_decay * _acc(p)
            return (_acc(p) - lr * step).to(p.dtype), m2, v2

        def upd_chunk(g, m, v, p):
            # upd's operations in upd's order, each rounded as there
            g = _acc(g)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            step = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
            step.add_(weight_decay * _acc(p)).mul_(lr)
            p.copy_(_acc(p) - step)

        def upd_inplace(g, m, v, p):
            # elementwise, so a leaf updated a slice at a time keeps upd's
            # bits, and its temporaries stay a slice's size (a 256000-row
            # embedding's fp32 temporaries are 8.4 GB each)
            flat = [t.view(-1) for t in (g, m, v, p)]
            for i in range(0, p.numel(), INPLACE_CHUNK):
                upd_chunk(*(t[i:i + INPLACE_CHUNK] for t in flat))
            return p, m, v

        new_p, new_m, new_v = tree_unzip(tree_map(upd_inplace if inplace else upd, grads,
                                                      state["m"], state["v"], params), 3)
        return new_p, {"m": new_m, "v": new_v, "t": t}

    return Optimizer(init, update)


def sgd(momentum=0.9, weight_decay=0.0005, inplace: bool = False) -> Optimizer:
    """Momentum SGD - Darknet's optimizer for the YOLO reproduction."""

    def init(params):
        return {"m": _zeros_acc(params), "t": 0}

    def update(grads, state, params, lr):
        def upd(g, m, p):
            g = _acc(g) + weight_decay * _acc(p)
            if inplace:
                m.mul_(momentum).add_(g)
                p.copy_(_acc(p) - lr * m)
                return p, m
            m2 = momentum * m + g
            return (_acc(p) - lr * m2).to(p.dtype), m2

        new_p, new_m = tree_unzip(tree_map(upd, grads, state["m"], params), 2)
        return new_p, {"m": new_m, "t": state["t"] + 1}

    return Optimizer(init, update)


def adafactor(**kw) -> Optimizer:
    raise NotImplementedError("adafactor is the LM side's optimizer: ROADMAP A.18")


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    if name == "sgd":
        return sgd(**kw)
    raise ValueError(f"unknown optimizer {name}")
