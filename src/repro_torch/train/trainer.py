"""Training step factory: grad accumulation, clipping, LR schedule,
optimizer update, optional int8-EF gradient compression - the tiled-CNN and
LM paths of ``repro/train/trainer.py``.

``make_train_step(arch, pcfg, tcfg)`` returns ``(init_state, train_step)``;
``on_grads(step, loss, grads)``, if given, sees each step's batch-end
gradients before the trainer tail, so a run's own gradients can be held
against a reference.
For a tiled-CNN bundle (``arch.kind == "tiled_cnn"``) the grads come from
``core.fusion.make_deferred_grad_step``: ``pcfg.grad_accum`` microbatches
accumulate per-tile weight-gradient partial sums, and one division by the
global count at batch end gives the final gradients - the paper's schedule.
Over a pipeline plan the same microbatches stream through the stages in one
autograd pass (``pcfg.grad_accum`` is the pipeline depth M).
For an LM bundle (``models.registry.ArchBundle``: a decoder-only LM or
Whisper's encoder-decoder) the grads come from autograd over
``arch.loss_fn``; with ``pcfg.grad_accum`` > 1 the
microbatches' grads are summed into fp32 zeros and divided once, and the
loss is the microbatches' mean, as the reference's scan does.  The LM step
updates the state in place (``inplace`` of ``optim.optimizers``): the state
it is given is consumed, as the reference's launcher donates it to ``jit``,
and the fp32 gradients ``on_grads`` sees are clipped where they lie after it
returns - an observer copies what it keeps.
The trainer tail then runs optional int8 error-feedback compression,
global-norm clipping, the cosine/warmup schedule and the optimizer update.

Elastic support (DESIGN.md §10): ``abstract_state`` (the state's shapes and
dtypes on the ``meta`` device, allocating nothing - the structure a restore
fills), ``globalize_state`` and ``check_state_matches``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.optim.compression import CompressionState, compress_with_feedback, init_error
from repro_torch.optim.optimizers import clip_by_global_norm, make_optimizer, tree_leaves, tree_map
from repro_torch.optim.schedules import cosine_schedule


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: int
    ef: Optional[Any] = None      # error-feedback buffers (compression)


def _make_init_state(arch, opt, tcfg: TrainConfig):
    def init_state(seed: int | torch.Generator = 0) -> TrainState:
        params = arch.init(seed)
        ef = init_error(params).error if tcfg.grad_compression == "int8" else None
        return TrainState(params, opt.init(params), 0, ef)

    return init_state


def _apply_updates(state: TrainState, loss, grads, opt, tcfg: TrainConfig,
                   inplace: bool = False):
    """Shared trainer tail: EF compression -> clip -> schedule -> update."""
    ef = state.ef
    if ef is not None:
        grads, st = compress_with_feedback(grads, CompressionState(ef))
        ef = st.error
    grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip, inplace=inplace)
    lr = cosine_schedule(state.step, tcfg.warmup, tcfg.steps, tcfg.lr)
    params, opt_state = opt.update(grads, state.opt, state.params, lr)
    new_state = TrainState(params, opt_state, state.step + 1, ef)
    return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}


def make_train_step(arch, pcfg: ParallelConfig, tcfg: TrainConfig, *, on_grads=None):
    from repro_torch.models.registry import ArchBundle

    if tcfg.grad_compression not in (None, "int8"):
        raise ValueError(f"grad_compression must be None or 'int8'; got {tcfg.grad_compression!r}")
    if getattr(arch, "kind", None) == "tiled_cnn":
        return _make_tiled_cnn_train_step(arch, pcfg, tcfg, on_grads)
    if isinstance(arch, ArchBundle):
        return _make_lm_train_step(arch, pcfg, tcfg, on_grads)
    raise TypeError(
        f"no training path for {type(arch).__name__}: the port trains tiled-CNN arches and "
        "the registry's bundles (decoder-only LMs and Whisper's encoder-decoder)")


def _unflatten(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def lm_value_and_grad(loss_fn, params, batch: dict):
    """(loss, grads) of ``loss_fn(params, batch)`` by autograd: the loss
    detached, the grads in each param's dtype, in the params' tree, each
    contiguous (the in-place optimizers update flat views: an unstacked
    leaf's einsum gradient, as the MTP layer's ``w_o``, comes back
    strided)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(live, batch)
    grads = [g.contiguous() for g in torch.autograd.grad(loss, tree_leaves(live))]
    return loss.detach(), _unflatten(params, grads)


def _make_lm_train_step(arch, pcfg: ParallelConfig, tcfg: TrainConfig, on_grads):
    opt = make_optimizer(tcfg.optimizer, weight_decay=tcfg.weight_decay, inplace=True)
    init_state = _make_init_state(arch, opt, tcfg)
    accum = pcfg.grad_accum

    def loss_fn(params, batch):
        return arch.loss_fn(params, batch, remat=pcfg.remat, unroll=pcfg.unroll,
                            ce_chunk=pcfg.ce_chunk)

    def split_batch(batch: dict) -> list[dict]:
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v, device=arch.device)
            dim = 1 if (k == "positions" and v.dim() == 3) else 0   # (3, B, T) splits on B
            if v.shape[dim] % accum:
                raise ValueError(f"batch entry {k!r} of {v.shape[dim]} rows not divisible by "
                                 f"grad_accum={accum}")
            out[k] = v.chunk(accum, dim=dim)
        return [{k: v[i] for k, v in out.items()} for i in range(accum)]

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if accum > 1:
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.promote_types(p.dtype, torch.float32), device=p.device),
                state.params)
            lsum = torch.zeros((), dtype=torch.float32, device=arch.device)
            for mb in split_batch(batch):
                l, g = lm_value_and_grad(loss_fn, state.params, mb)
                tree_map(lambda a, b: a.add_(b), gsum, g)
                del g
                lsum = lsum + l
            grads = tree_map(lambda g: g.div_(accum), gsum)
            loss = lsum / accum
        else:
            batch = {k: torch.as_tensor(v, device=arch.device) for k, v in batch.items()}
            loss, grads = lm_value_and_grad(loss_fn, state.params, batch)
        if on_grads is not None:
            on_grads(state.step, loss, grads)
        return _apply_updates(state, loss, grads, opt, tcfg, inplace=True)

    return init_state, train_step


def _make_tiled_cnn_train_step(arch, pcfg: ParallelConfig, tcfg: TrainConfig, on_grads):
    from repro_torch.core.fusion import make_deferred_grad_step

    opt = make_optimizer(tcfg.optimizer, weight_decay=tcfg.weight_decay)
    init_state = _make_init_state(arch, opt, tcfg)
    accum = max(pcfg.grad_accum, 1)
    grad_step = make_deferred_grad_step(arch.plan, arch.mesh, arch.loss_local,
                                        microbatches=accum)

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        def split(v):
            v = torch.as_tensor(v, device=arch.mesh.device)
            if v.shape[0] % accum:
                raise ValueError(
                    f"global batch {v.shape[0]} not divisible by "
                    f"grad_accum={accum} (tiled-CNN microbatch split)"
                )
            return v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:]))

        plan = arch.plan
        if plan.stages:
            # the trainer's words for the pipeline batch rule: each of the
            # grad_accum microbatches streamed through the stages must split
            # over one stage's tiles
            per = (plan.n * plan.m) // len(plan.stages)
            b = batch["x"].shape[0]
            if b % accum or (b // accum) % per:
                raise ValueError(
                    f"pipeline plan with {len(plan.stages)} stages needs "
                    f"the global batch ({b}) divisible by grad_accum "
                    f"({accum}) and the per-microbatch batch by the "
                    f"devices per stage ({per}); adjust --batch/--grad-accum"
                )
        loss, grads = grad_step(state.params, split(batch["x"]), split(batch["t"]))
        if on_grads is not None:
            on_grads(state.step, loss, grads)
        return _apply_updates(state, loss, grads, opt, tcfg)

    train_step.grad_step = grad_step     # its ``census`` after a pipeline plan's step
    return init_state, train_step


# ---------------------------------------------------------------------------
# Elastic replan support (DESIGN.md §10)
# ---------------------------------------------------------------------------


def abstract_of(init_state, seed: int = 0) -> tuple[Any, Optional[torch.device]]:
    """``init_state(seed)`` traced for its structure alone: the state with
    each tensor leaf replaced by an empty ``meta`` tensor of its shape and
    dtype (ints stay ints), and the device the real state would live on.
    It runs under ``FakeTensorMode``, so nothing is drawn or allocated: a
    restore's "like" structure for a full-width LM costs no device memory."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.ckpt.manager import map_with_path

    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = init_state(seed)
    devices = []

    def to_meta(_, x):
        if isinstance(x, torch.Tensor):
            devices.append(x.device)
            return torch.empty(x.shape, dtype=x.dtype, device="meta")
        return x

    return map_with_path(to_meta, fake), (devices[0] if devices else None)


def abstract_state(arch, pcfg: ParallelConfig, tcfg: TrainConfig) -> TrainState:
    """The TrainState's shapes and dtypes as ``meta`` tensors (a dry run:
    no allocation) - the reference's ``jax.eval_shape`` of ``init_state``."""
    init_state, _ = make_train_step(arch, pcfg, tcfg)
    return abstract_of(init_state)[0]


def globalize_state(state: TrainState) -> TrainState:
    """A host copy of a live TrainState - the partition-independent form.
    On the virtual tile mesh every param and optimizer statistic is
    already a whole (global) tensor, so a replan keeps the live state as it
    is; this copy is what a checkpoint holds, detached from the device."""
    from repro_torch.ckpt.manager import map_with_path

    return map_with_path(
        lambda _, x: x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x, state)


def check_state_matches(state: Any, like: Any) -> None:
    """Validate that ``state`` is structurally interchangeable with ``like``
    (the same leaf paths, shapes and dtypes; an int leaf is a 0-d int32) -
    the guard before handing a restored or carried-over state to a step
    built for another plan.  Raises ValueError naming the first offending
    leaf path."""
    from repro_torch.ckpt.manager import leaf_meta, map_with_path

    def collect(tree):
        out = {}
        map_with_path(lambda p, x: out.__setitem__(p, leaf_meta(x)), tree)
        return out

    paths_a, paths_b = collect(state), collect(like)
    for path in sorted(set(paths_a) | set(paths_b)):
        if path not in paths_a:
            raise ValueError(f"state missing leaf {path!r} expected by plan")
        if path not in paths_b:
            raise ValueError(f"state has extra leaf {path!r} not in plan")
        (sa, da), (sb, db) = paths_a[path], paths_b[path]
        if sa != sb:
            raise ValueError(f"state leaf {path!r} shape {sa} != plan {sb}")
        if da != db:
            raise ValueError(f"state leaf {path!r} dtype {da} != plan {db}")
