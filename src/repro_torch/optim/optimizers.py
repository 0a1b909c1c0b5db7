"""Optimizers as (init, update) pairs over param trees, as
``repro/optim/optimizers.py``.

A param tree is what the tiled CNN uses: a list of per-layer dicts of
tensors (any nesting of lists and dicts of tensors works).  States
are dicts of fp32 tensors mirroring the params, under the reference's keys
(``m``, ``v``, ``t``; ``t`` the update count, a 0-d int32 tensor on the
params' device, as the reference's ``jnp.int32``: AdamW's bias corrections
are tensors computed from it, so a captured step reads the count where it
lies at every replay; a host int ``t`` is taken too).  ``lr`` is a
float or a 0-d tensor.  Updates are out of place, as in the
reference: a step returns new params and a new state.  The arithmetic is
the reference's fp32; fp64 params (an exact reference run) keep fp64
throughout.

``inplace=True`` (``clip_by_global_norm``, ``adamw``, ``adafactor``,
``sgd``) writes the results into the tensors it was given instead - the
same arithmetic and the same bits, with only one leaf's temporaries alive
at a time (adamw and adafactor: one slice of about ``INPLACE_CHUNK``
elements of a leaf).  The LM trainer
uses it, since a full-width model's fp32 moments and gradients leave no room
for a second copy; it stands where the reference's launcher donates the
state to ``jit``.  The caller must not reuse the old state.

adamw: fp32 moments.  adafactor: a factored second moment, no momentum
(about half of AdamW's state bytes for a full-width LM).  sgd: momentum SGD
(Darknet's, for the YOLO reproduction).
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


def init_count(params) -> torch.Tensor:
    """A zero update count (0-d int32) on the device of ``params``' first
    tensor leaf (the CPU for a tree without one)."""
    leaves = [x for x in tree_leaves(params) if isinstance(x, torch.Tensor)]
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else "cpu")


def as_count(t, params) -> torch.Tensor:
    """A count as a 0-d int32 tensor: ``t`` itself, or a host int put on
    the device of ``params``' first tensor leaf."""
    return t if isinstance(t, torch.Tensor) else init_count(params) + int(t)


def _zeros_acc(params):
    return tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.promote_types(p.dtype, torch.float32), device=p.device), params)


# elements of a leaf the in-place AdamW updates at a time
INPLACE_CHUNK = 1 << 26


def bias_corrections(t: torch.Tensor, b1: float, b2: float) -> tuple[torch.Tensor, torch.Tensor]:
    """AdamW's ``1 - b ** t`` for both moments at the count ``t``: fp64
    tensors on ``t``'s device, the values a host count gives as Python
    floats (an fp32 update rounds them once)."""
    return 1 - b1 ** t.double(), 1 - b2 ** t.double()


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, inplace: bool = False) -> Optimizer:
    def init(params):
        return {"m": _zeros_acc(params), "v": _zeros_acc(params), "t": init_count(params)}

    def update(grads, state, params, lr):
        t = as_count(state["t"], params) + 1
        bc1, bc2 = bias_corrections(t, b1, b2)

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
        return {"m": _zeros_acc(params), "t": init_count(params)}

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
        return new_p, {"m": new_m, "t": as_count(state["t"], params) + 1}

    return Optimizer(init, update)


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128


def adafactor(decay=0.99, eps=1e-30, clip_threshold=1.0, weight_decay=0.0,
              inplace: bool = False) -> Optimizer:
    """Factored second-moment estimator (Shazeer & Stern 2018), momentum-free,
    as the reference's.  A leaf whose last two dims are both >= 128 keeps row
    and column statistics (``vr``, ``vc``) over those two dims, one pair per
    leading index of a stacked leaf; any other leaf a full ``v``.  The
    update's RMS is clipped over the whole leaf, all repeats together.

    A leaf is updated in slices along its leading dims: whole matrices, as
    many as ``INPLACE_CHUNK`` elements hold (at least one); a leaf that is
    not factored in flat slices of ``INPLACE_CHUNK``.  Two passes: (1) each
    slice's new statistics and the sum of its squared step; (2) each
    slice's step again, clipped by the leaf's RMS, and applied.  Both modes
    run the same passes, so ``inplace`` gives the out-of-place bits, and the
    temporaries stay a slice's size (unsliced, a stacked expert leaf of 3 x
    8 x 6144 x 16384 would hold 9.7 GB fp32 temporaries each)."""

    def init(params):
        def leaf(p):
            def zeros(shape):
                return torch.zeros(shape, dtype=torch.promote_types(p.dtype, torch.float32),
                                   device=p.device)

            if _factored(p.shape):
                return {"vr": zeros(p.shape[:-1]), "vc": zeros(p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p.shape)}

        return {"v": tree_map(leaf, params), "t": init_count(params)}

    def update(grads, state, params, lr):
        def upd(g, s, p):
            new_p = p if inplace else torch.empty_like(p)
            new_s = s if inplace else {k: torch.empty_like(v) for k, v in s.items()}
            if _factored(p.shape):
                rows, cols = p.shape[-2:]
                g_v, p_v, out_v = (t.reshape(-1, rows, cols) for t in (g, p, new_p))
                old = [s["vr"].reshape(-1, rows), s["vc"].reshape(-1, cols)]
                new = [new_s["vr"].reshape(-1, rows), new_s["vc"].reshape(-1, cols)]
                per = max(1, INPLACE_CHUNK // (rows * cols))
            else:
                g_v, p_v, out_v = (t.reshape(-1) for t in (g, p, new_p))
                old, new = [s["v"].reshape(-1)], [new_s["v"].reshape(-1)]
                per = INPLACE_CHUNK
            slices = [slice(i, i + per) for i in range(0, g_v.shape[0], per)]

            def step_of(gs, sl):
                # the reference's step from this slice's new statistics
                if len(new) == 2:
                    vr, vc = new[0][sl], new[1][sl]
                    denom = torch.mean(vr, dim=-1, keepdim=True)
                    r = (vr / torch.clamp(denom, min=eps))[..., None] * vc[..., None, :]
                else:
                    r = new[0][sl].clone()
                return r.clamp_(min=eps).rsqrt_().mul_(gs)

            squares = []
            for sl in slices:
                gs = _acc(g_v[sl])
                g2 = gs * gs + eps
                means = [torch.mean(g2, dim=-1), torch.mean(g2, dim=-2)] if len(new) == 2 \
                    else [g2]
                for o, nw, mean in zip(old, new, means):
                    nw[sl].copy_(decay * o[sl] + (1 - decay) * mean)
                del g2, means
                squares.append(torch.sum(step_of(gs, sl).square_()))
            rms = torch.sqrt(torch.stack(squares).sum() / p.numel() + 1e-12)
            scale = torch.clamp(rms / clip_threshold, min=1.0)
            for sl in slices:
                step = step_of(_acc(g_v[sl]), sl).div_(scale)
                if weight_decay:
                    step = step + weight_decay * _acc(p_v[sl])
                out_v[sl].copy_(_acc(p_v[sl]) - step.mul_(lr))
            return new_p, new_s

        new_p, new_v = tree_unzip(tree_map(upd, grads, state["v"], params), 2)
        return new_p, {"v": new_v, "t": as_count(state["t"], params) + 1}

    return Optimizer(init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    if name == "sgd":
        return sgd(**kw)
    raise ValueError(f"unknown optimizer {name}")
