"""Optimizers as (init, update) pairs over param trees, as
``repro/optim/optimizers.py``.

A param tree is what the tiled CNN uses: a list of per-layer dicts of
tensors (any nesting of lists and dicts of tensors works).  States
are dicts of fp32 tensors mirroring the params, under the reference's keys
(``m``, ``v``, ``t``; ``t`` an int).  Updates are out of place, as in the
reference: a step returns new params and a new state.  The arithmetic is
the reference's fp32; fp64 params (an exact reference run) keep fp64
throughout.

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


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda g: (_acc(g) * scale).to(g.dtype), tree), norm


def _zeros_acc(params):
    return tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.promote_types(p.dtype, torch.float32), device=p.device), params)


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
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

        new_p, new_m, new_v = tree_unzip(tree_map(upd, grads, state["m"], state["v"], params), 3)
        return new_p, {"m": new_m, "v": new_v, "t": t}

    return Optimizer(init, update)


def sgd(momentum=0.9, weight_decay=0.0005) -> Optimizer:
    """Momentum SGD - Darknet's optimizer for the YOLO reproduction."""

    def init(params):
        return {"m": _zeros_acc(params), "t": 0}

    def update(grads, state, params, lr):
        def upd(g, m, p):
            g = _acc(g) + weight_decay * _acc(p)
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
